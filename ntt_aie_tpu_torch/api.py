"""High-level API: NTTContext on one device or over a mesh of ranks.

Port of ``ntt_aie_tpu.api.NTTContext``: the context builds its plan
lazily on first use and delegates to it; the host-oracle paths run the
NumPy oracles in the plan's output order. With ``mesh=`` (a
``parallel.mesh`` DeviceMesh) it runs the distributed four-step plan on
every rank of the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.utils.device import resolve_device


class NTTContext:
    """A plan: forward / inverse / polymul.

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

    With mesh= (parallel.mesh's make_mesh and kin, called on every rank),
    every rank builds the distributed plan (parallel.fourstep; keyword
    arguments dp_axis, overlap_chunks, wmat_factored, hier_axes; for
    Goldilocks all but dp_axis). A flat host vector (a (B, n) batch with
    dp_axis; uint64 for Goldilocks) is placed into the rank's block; a
    value with the block's rank (a tensor, a NumPy array or a (hi, lo)
    pair) is this rank's block and passes through. In the default
    spectral ordering the outputs are this rank's blocks; with
    ordering='natural' every rank passes the same flat vector and gets
    the whole flat natural-order result back (an all_gather). The
    reference-parity conventions are single-device modes and raise with
    mesh=, as ordering='natural' with dp_axis does; make_batched is
    single-device (dp_axis is the distributed batch).
    """

    _PLAN_KWARGS = {"fused", "wmat_factored", "wmat_fold"}
    _GL_MESH_KWARGS = {"overlap_chunks", "hier_axes", "wmat_factored"}

    def __init__(self, config: NTTConfig, *, device=None, mesh=None,
                 **plan_kwargs):
        if mesh is None:
            bad = sorted(set(plan_kwargs) - self._PLAN_KWARGS)
            if bad:
                raise TypeError(
                    f"plan kwargs {bad} need mesh= (they configure the "
                    "distributed plan builder); single-device contexts "
                    f"accept {sorted(self._PLAN_KWARGS)}")
        if mesh is not None and (config.table_convention == "reference"
                                 or config.ordering == "reference"):
            raise NotImplementedError(
                "the reference parity conventions (table_convention/"
                "ordering='reference') are single-chip modes — the "
                "reference butterfly network is not a DFT and has no "
                "four-step decomposition (SURVEY.md §0); drop mesh=")
        if mesh is not None and config.ordering == "natural" and \
                plan_kwargs.get("dp_axis"):
            raise NotImplementedError(
                "ordering='natural' is not wired for dp_axis-batched "
                "meshes (the gather wrapper assumes flat vectors); use "
                "the default spectral ordering")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self._plan_kwargs = plan_kwargs
        self._plan = None
        self._calls = None

    @property
    def plan(self):
        if self._plan is None:
            if self.mesh is not None:
                self._plan, self._calls = self._build_distributed()
            else:
                from ntt_aie_tpu_torch.plan import build_plan

                self._plan = build_plan(self.config, device=self.device,
                                        **self._plan_kwargs)
                self._calls = {"fwd": self._plan.fwd, "inv": self._plan.inv,
                               "polymul": self._plan.polymul,
                               "negacyclic_polymul":
                                   self._plan.negacyclic_polymul}
        return self._plan

    def _build_distributed(self) -> tuple:
        """The distributed plan of this rank and the context's callables
        on it (reference api.py:117-257)."""
        from ntt_aie_tpu_torch.parallel import fourstep as FS

        cfg = self.config
        gl = cfg.field.is_goldilocks
        if gl:
            bad = sorted(set(self._plan_kwargs) - self._GL_MESH_KWARGS)
            if bad:
                raise TypeError(
                    f"plan kwargs {bad} are not supported by the Goldilocks "
                    f"distributed builder here (only "
                    f"{sorted(self._GL_MESH_KWARGS)})")
            plan = FS.build_gl_distributed_plan(cfg, self.mesh,
                                                device=self.device,
                                                **self._plan_kwargs)
        else:
            plan = FS.build_distributed_plan(cfg, self.mesh,
                                             device=self.device,
                                             **self._plan_kwargs)
        host_ndim = 1 if plan.dp_axis is None else 2

        def placed(x, place):
            """(this rank's block, whether to return uint64)."""
            arr = x[0] if isinstance(x, tuple) else x
            if np.ndim(arr) > host_ndim:
                if gl and not isinstance(x, tuple):
                    from ntt_aie_tpu_torch.ops.modops import gl_from_u64

                    return gl_from_u64(np.asarray(x), self.device), True
                return x, False
            return place(x), gl and not isinstance(x, tuple)

        def out(y, u64):
            if u64:
                from ntt_aie_tpu_torch.ops.modops import gl_to_u64

                return gl_to_u64(*y)
            return y

        def one(fn, place):
            def call(a):
                x, u64 = placed(a, place)
                return out(fn(x), u64)

            return call

        def two(fn):
            def call(a, b):
                x, u64 = placed(a, plan.shard_input)
                y, _ = placed(b, plan.shard_input)
                return out(fn(x, y), u64)

            return call

        calls = {"fwd": one(plan.fwd, plan.shard_input),
                 "inv": one(plan.inv, plan.shard_spectral),
                 "polymul": two(plan.polymul),
                 "negacyclic_polymul": (two(plan.negacyclic_polymul)
                                        if plan.negacyclic_polymul
                                        else None)}
        if cfg.ordering == "natural":
            calls.update(self._natural(plan, gl))
        return plan, calls

    def _natural(self, plan, gl: bool) -> dict:
        """forward/inverse/polymul on whole flat natural-order vectors:
        each rank places its block, and the outputs are gathered over the
        shard axis (reference api.py:146-173, :220-239)."""
        n = self.config.n
        pos = plan.spectral_to_natural.astype(np.int64)
        pos_d = torch.from_numpy(pos).to(self.device)
        inv_perm = np.empty(n, dtype=np.int64)
        inv_perm[pos] = np.arange(n)

        def planes(v):
            return v if gl else (v,)

        def flat(v, idx=None):
            v = tuple(t.reshape(n) if idx is None else
                      t.reshape(n).index_select(0, idx)
                      for t in planes(plan.gather(v)))
            if not gl:
                return v[0]
            from ntt_aie_tpu_torch.ops.modops import gl_to_u64

            return gl_to_u64(*v)

        def host(v):
            if isinstance(v, tuple):
                return tuple(np.asarray(t).reshape(-1) for t in v)
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            return np.asarray(v).reshape(-1)

        def inverse(s):
            s = host(s)
            if (s[0] if isinstance(s, tuple) else s).shape != (n,):
                raise ValueError(
                    f"ordering='natural' inverse expects a flat ({n},) "
                    f"natural-order spectrum")
            s = (tuple(t[inv_perm] for t in s) if isinstance(s, tuple)
                 else s[inv_perm])
            return flat(plan.inv(plan.shard_spectral(s)))

        out = {"fwd": lambda a: flat(plan.fwd(plan.shard_input(a)), pos_d),
               "inv": inverse,
               "polymul": lambda a, b: flat(plan.polymul(
                   plan.shard_input(a), plan.shard_input(b)))}
        if plan.negacyclic_polymul is not None:
            out["negacyclic_polymul"] = lambda a, b: flat(
                plan.negacyclic_polymul(plan.shard_input(a),
                                        plan.shard_input(b)))
        return out

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
        (flat (B, n)) and the matrix-form fwd_mat/inv_mat/polymul_mat.
        Single-device contexts only."""
        if self.mesh is not None:
            raise NotImplementedError(
                "make_batched is the single-chip serving surface; with "
                "mesh= use dp_axis= on the distributed builder (a 2D "
                "dp x coeff mesh) for batched serving")
        return self.plan.make_batched(batch)

    def _mat(self, name):
        fn = getattr(self.plan, name, None)
        if fn is None:
            raise NotImplementedError(
                f"this plan has no {name} (a flat plan, split (n, 1), has "
                "no matrix-form twins, as the reference's has none; the "
                "fwd/inv twins need the default spectral ordering; the "
                "negacyclic twin needs NTTConfig(negacyclic=True); a "
                "distributed plan has none)")
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

    def _call(self, name):
        self.plan  # noqa: B018 (builds it)
        return self._calls[name]

    def forward(self, a):
        return self._call("fwd")(a)

    def inverse(self, a):
        return self._call("inv")(a)

    def polymul(self, a, b):
        return self._call("polymul")(a, b)

    def negacyclic_polymul(self, a, b):
        """a * b in Z_p[X]/(X^n + 1) (RLWE-style). Requires
        NTTConfig(negacyclic=True) so the psi tables were planned."""
        if not self.config.negacyclic:
            raise ValueError(
                "negacyclic_polymul needs NTTConfig(negacyclic=True)")
        return self._call("negacyclic_polymul")(a, b)
