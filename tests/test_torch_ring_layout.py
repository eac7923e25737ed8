"""The FIPS 203/204 ring kernels' register layout, modelled in NumPy on the
CPU.

``csrc/ring_layers.cu`` runs one polynomial a warp, 8 values a lane in
registers: loaded in the stride layout (lane t, register j: coefficient
t + 32 j), each layer a butterfly on the register pairs that differ in its
coefficient bit, and a bit that a lane holds brought into a register by a
swap (``__shfl_xor_sync``: register bit kSwapReg[s] exchanged with lane
bit kSwapLane[s]). No CUDA compiler or card runs here, so this file reads
the layout's constants out of the source (the stride layout, the swap
schedule, the shared-memory swizzle), runs the kernels' index maps lane by
lane on NumPy arrays of shape (batch, 32 lanes, 8 registers) with the
kernels' arithmetic (ML-KEM's (a z) mod q, ML-DSA's Montgomery REDC, the
lazy values inside a transform and the fused product's raw sums, each
reduced once, their bounds asserted), and holds the results raw against
the port's plain versions and the JAX package: the transforms against
``layered_plain`` and ``kyber_ntt``/``kyber_intt``/``dilithium_ntt``/
``dilithium_intt``, the fused product (ntt -> sum_j basemul or pointwise
-> intt) against the JAX package's jitted ``make_pipeline`` callables at
ML-KEM-768 (3 x 3) and ML-DSA-65 (6 x 5). It also counts the bank
wavefronts of every shared-memory access the kernels make (the zeta and
gamma runs, the shared matrix and the transformed vectors on their
swizzled chunks), as ``tests/test_torch_colpass_layout.py`` counts the
column kernel's: one a phase of 128 bytes.
"""

import collections
import functools
import re

import numpy as np
import pytest

from ntt_aie_tpu import dilithium as JD
from ntt_aie_tpu import kyber as JK

from ntt_aie_tpu_torch import dilithium as D
from ntt_aie_tpu_torch import kyber as K
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import ring_layers as LR

import torch

SRC = (C.CSRC_DIR / "ring_layers.cu").read_text()
M32 = (1 << 32) - 1
LANES, REGS, N = 32, 8, 256


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _array(name):
    body = re.search(rf"constexpr int {name}\[\w+\] = \{{([^}}]*)\}};",
                     SRC).group(1)
    return tuple(int(v) for v in body.split(","))


STRIDE = tuple(int(v) for v in re.search(
    r"constexpr int kStrideLayout = layout_of\(([^)]*)\);", SRC)
    .group(1).split(","))
SWAPS = _const("kSwaps")
SWAP_REG, SWAP_LANE = _array("kSwapReg"), _array("kSwapLane")
SWIZZLE_SHIFT = _const("kSwizzleShift")
MAX_RANK = _const("kMaxRank")
SCHEMES = {"kyber": (K, JK), "dilithium": (D, JD)}
SERVING = {"kyber": (3, 3), "dilithium": (6, 5)}  # ML-KEM-768, ML-DSA-65


class Layout(collections.namedtuple("Layout", "reg lane")):
    """reg[p]: the coefficient bit register-index bit p holds; lane[q]:
    the one lane bit q holds."""

    def swapped(self, s):
        reg, lane = list(self.reg), list(self.lane)
        p, q = SWAP_REG[s], SWAP_LANE[s]
        reg[p], lane[q] = lane[q], reg[p]
        return Layout(tuple(reg), tuple(lane))

    def coeff(self):
        """(32, 8): the coefficient index lane t's register j holds."""
        t = np.arange(LANES)[:, None]
        j = np.arange(REGS)[None, :]
        i = np.zeros((LANES, REGS), dtype=np.int64)
        for p, b in enumerate(self.reg):
            i |= ((j >> p) & 1) << b
        for q, b in enumerate(self.lane):
            i |= ((t >> q) & 1) << b
        return i


@functools.cache
def layout_after(s):
    lay = Layout(STRIDE[:3], STRIDE[3:])
    for i in range(s):
        lay = lay.swapped(i)
    return lay


FINAL = layout_after(SWAPS)


def lane_part(lay, y):
    """The kernel's lane_part: the lane bits' share of i >> (y + 1)."""
    t = np.arange(LANES)
    b = np.zeros(LANES, dtype=np.int64)
    for q, bit in enumerate(lay.lane):
        if bit > y:
            b |= ((t >> q) & 1) << (bit - y - 1)
    return b


def run_offset(lay, y, j):
    """The kernel's run_offset: register j's entry in its lane's run."""
    return sum(((j >> p) & 1) << (b - y - 1)
               for p, b in enumerate(lay.reg) if b > y)


def run_log(lay, y):
    return sum(b > y for b in lay.reg)


# --- the kernels' arithmetic on int64 arrays --------------------------------

# MlKem then MlDsa: kLazy (lazy_mul's bound in multiples of q), ML-DSA's
# q^-1 mod 2^32
LAZY = dict(zip(("kyber", "dilithium"),
                (int(v) for v in re.findall(
                    r"static constexpr uint32_t kLazy = (\d+);", SRC))))
Q_INV = int(re.search(r"kQInv = (\d+)u;", SRC).group(1))


def mul(sch, a, z):
    """MlKem::mul / MlDsa::mul, canonical (ML-KEM: a z < 2^32; ML-DSA:
    a < 2^32, z < q)."""
    a, z = np.asarray(a, np.int64), np.asarray(z, np.int64)
    assert a.max() < 1 << 32
    if sch.neg_pinv == 0:
        assert (a * z).max() < 1 << 32
        return (a * z) % sch.q
    prod = (a.astype(np.uint64) * z.astype(np.uint64))
    lo, hi = prod & np.uint64(M32), prod >> np.uint64(32)
    m = (lo * np.uint64(sch.neg_pinv)) & np.uint64(M32)
    t = (hi + ((m * np.uint64(sch.q)) >> np.uint64(32))
         + (lo != 0).astype(np.uint64)).astype(np.int64)
    assert t.max() < 2 * sch.q
    return np.where(t >= sch.q, t - sch.q, t)


def lazy_mul(sch, a, z):
    """lazy_mul: ML-KEM's is mul; ML-DSA's REDC hi - umulhi(lo q^-1, q)
    + q, in (0, 2q)."""
    if sch.neg_pinv == 0:
        return mul(sch, a, z)
    a, z = np.asarray(a, np.int64), np.asarray(z, np.int64)
    assert a.max() < 1 << 32 and Q_INV * sch.q % (1 << 32) == 1
    prod = a.astype(np.uint64) * z.astype(np.uint64)
    lo, hi = prod & np.uint64(M32), prod >> np.uint64(32)
    m = (lo * np.uint64(Q_INV)) & np.uint64(M32)
    t = (hi.astype(np.int64) + sch.q
         - ((m * np.uint64(sch.q)) >> np.uint64(32)).astype(np.int64))
    assert t.min() > 0 and t.max() < 2 * sch.q
    return t


def bfly(sch, u, v, z, inverse, done):
    """bfly<S, inverse, done>: lazy values, below (1 + kLazy done) q
    forward and 2^done q inverse (asserted), never reduced inside."""
    q, lazy = sch.q, LAZY[sch.name]
    if inverse:
        bound = (1 << done) * q
        assert max(u.max(), v.max()) < bound
        s, v = u + v, lazy_mul(sch, u + bound - v, z)
        assert s.max() < 2 * bound <= M32 + 1
        return s, v
    assert max(u.max(), v.max()) < (1 + lazy * done) * q
    t = lazy_mul(sch, v, z)
    out = u + t, u + lazy * q - t
    assert min(o.min() for o in out) >= 0
    assert max(o.max() for o in out) < (1 + lazy * (done + 1)) * q <= M32
    return out


# --- the model --------------------------------------------------------------

class Model:
    """One scheme's kernels on (batch, 32, 8) register arrays. `accesses`
    records each shared-memory access as (what, per-lane first words,
    words a lane)."""

    def __init__(self, sch):
        self.sch = sch
        self.table = sch.product_table().astype(np.int64)
        self.words = 1 << sch.n_layers  # one direction's flat table
        self.accesses = []

    def load(self, v, lay):
        return v.reshape(-1, N)[:, lay.coeff()]

    def store(self, r, lay):
        out = np.empty((r.shape[0], N), dtype=np.int64)
        out[:, lay.coeff()] = r
        return out

    def swap(self, r, s):
        """swap_step<s>: register bit SWAP_REG[s] with lane bit
        SWAP_LANE[s], the kernel's selects around one shuffle a pair."""
        step, mask = 1 << SWAP_REG[s], 1 << SWAP_LANE[s]
        hi = ((np.arange(LANES) & mask) != 0)[None, :]
        partner = np.arange(LANES) ^ mask
        r = r.copy()
        for j in range(REGS):
            if j & step:
                continue
            send = np.where(hi, r[:, :, j], r[:, :, j | step])
            recv = send[:, partner]
            r[:, :, j], r[:, :, j | step] = (
                np.where(hi, recv, r[:, :, j]),
                np.where(hi, r[:, :, j | step], recv))
        return r

    def layer(self, r, lay, y, inverse):
        """layer<S, inverse, lay, y>: the lane's run of zetas (one load of
        2^run_log words) and 4 butterflies; checks the run against the
        standards' index 2^L + (i >> (y + 1)) of both pair members."""
        level = 7 - y
        p = lay.reg.index(y)
        m = run_log(lay, y)
        base = (1 << level) + lane_part(lay, y)
        assert np.all(base % (1 << m) == 0)
        off = self.words if inverse else 0
        self.accesses.append((f"zetas L{level}", off + base, 1 << m))
        ci = lay.coeff()
        done = y - (8 - self.sch.n_layers) if inverse else level
        r = r.copy()
        for j in range(REGS):
            if j & (1 << p):
                continue
            h = j | (1 << p)
            idx = base + run_offset(lay, y, j)
            assert 0 <= run_offset(lay, y, j) < 1 << m
            assert np.array_equal(ci[:, h], ci[:, j] + (1 << y))
            assert np.array_equal(idx, (1 << level) + (ci[:, j] >> (y + 1)))
            z = self.table[off + idx][None, :]
            r[:, :, j], r[:, :, h] = bfly(self.sch, r[:, :, j], r[:, :, h], z,
                                          inverse, done)
        return r

    def forward(self, r):
        """forward<S>: stride layout in, the final layout out, reduced
        mod q once at the end."""
        step = 0
        for y in range(7, 7 - self.sch.n_layers, -1):
            while y not in layout_after(step).reg:
                r, step = self.swap(r, step), step + 1
            r = self.layer(r, layout_after(step), y, False)
        while step < SWAPS:
            r, step = self.swap(r, step), step + 1
        return r % self.sch.q

    def inverse(self, r, scale):
        """inverse<S> and the final multiply: the final layout in, the
        stride layout out."""
        step = SWAPS
        for y in range(8 - self.sch.n_layers, 8):
            while y not in layout_after(step).reg:
                step -= 1
                r = self.swap(r, step)
            r = self.layer(r, layout_after(step), y, True)
        while step > 0:
            step -= 1
            r = self.swap(r, step)
        return mul(self.sch, r, scale)

    def ntt(self, v):
        return self.store(self.forward(self.load(v, layout_after(0))),
                          FINAL).reshape(v.shape)

    def intt(self, v):
        r = self.inverse(self.load(v, FINAL), self.sch.scale)
        return self.store(r, layout_after(0)).reshape(v.shape)

    def row_sums(self, terms):
        """RowSums<S>: the row's terms [(a, x), ...] summed raw and reduced
        once. ML-KEM, a pair (j, h) differing in bit 0 (its gamma one run
        of 4 a lane): sum a_j x_j, sum a_h x_h, sum (a_j x_h + a_h x_j)
        held below 2^32, then (lo + (hi mod q) gamma) mod q and cross mod
        q. ML-DSA: sum a x held below 2^32 q, one REDC (times R^-1)."""
        sch = self.sch
        shape = terms[0][0].shape
        r = np.empty(shape, dtype=np.int64)
        if sch.gammas:
            p = FINAL.reg.index(0)
            base = 2 * self.words + lane_part(FINAL, 0)
            self.accesses.append(("gammas", base, 1 << run_log(FINAL, 0)))
            ci = FINAL.coeff()
            for j in range(REGS):
                if j & (1 << p):
                    continue
                h = j | (1 << p)
                lo = sum(a[..., j] * x[..., j] for a, x in terms)
                hi = sum(a[..., h] * x[..., h] for a, x in terms)
                cross = sum(a[..., j] * x[..., h] + a[..., h] * x[..., j]
                            for a, x in terms)
                assert max(lo.max(), hi.max(), cross.max()) < 1 << 32
                idx = base + run_offset(FINAL, 0, j)
                assert np.array_equal(idx - 2 * self.words, ci[:, j] >> 1)
                g = self.table[idx][None, :]
                c0 = lo + (hi % sch.q) * g
                assert c0.max() < 1 << 32
                r[..., j], r[..., h] = c0 % sch.q, cross % sch.q
            return r
        total = sum(a.astype(object) * x for a, x in terms)
        assert max(int(v) for v in total.ravel()) < sch.q << 32
        t = total.astype(np.uint64)
        m = ((t & np.uint64(M32)) * np.uint64(sch.neg_pinv)) & np.uint64(M32)
        red = ((t + m * np.uint64(sch.q)) >> np.uint64(32)).astype(np.int64)
        assert red.max() < 2 * sch.q
        return np.where(red >= sch.q, red - sch.q, red)

    def product(self, x, a, mode):
        """ring_product_kernel on the batched form (x (B, l, n); a (k, l,
        n) shared or (B, k, l, n)): out (B, k, n)."""
        fwd_x, fwd_a, inv, matrix = LR.MODES[mode]
        sch = self.sch
        B, l = x.shape[0], x.shape[1]
        k = a.shape[-3]
        xr = (self.forward(self.load(x, layout_after(0))) if fwd_x
              else self.load(x, FINAL)).reshape(B, l, LANES, REGS)
        shared = a.ndim == 3
        if fwd_a:
            ar = self.forward(self.load(a, layout_after(0)))
        else:
            ar = self.load(a, FINAL)
        ar = ar.reshape((1 if shared else B), k, l, LANES, REGS)
        out = np.empty((B, k, N), dtype=np.int64)
        for i in range(k):
            r = self.row_sums([(np.broadcast_to(ar[:, i, j], xr[:, j].shape),
                                xr[:, j]) for j in range(l)])
            if inv:
                r = self.inverse(r, sch.product_scale)
                out[:, i] = self.store(r, layout_after(0))
            else:
                r = r if sch.gammas else mul(sch, r, sch.fixup)
                out[:, i] = self.store(r, FINAL)
        return out


# --- shared-memory wavefronts -------------------------------------------------

def wavefronts(first, words):
    """Bank wavefronts of one warp access: lane t reads or writes `words`
    consecutive 4-byte words from word first[t] (one 4-, 8- or 16-byte
    access a lane). The warp goes in phases of 128 bytes (32 // words
    lanes); a phase takes as many wavefronts as the most distinct words
    it touches in one of the 32 banks. Returns the count of each phase."""
    per = LANES // words
    out = []
    for ph in range(words):
        touched = {int(first[t]) + w for t in range(ph * per, (ph + 1) * per)
                   for w in range(words)}
        banks = collections.Counter(w % 32 for w in touched)
        out.append(max(banks.values()))
    return out


def swizzle_chunk(c, shift=SWIZZLE_SHIFT):
    return c ^ ((c >> shift) & 1)


def smem_poly_accesses(shift=SWIZZLE_SHIFT):
    """load_final_smem / store_final_smem: lane t's chunks 2t and 2t + 1
    (16 bytes each, one access each) at their swizzled places; and the
    shared matrix's fill, thread c of a warp writing chunk c (32
    consecutive chunks an access)."""
    t = np.arange(LANES)
    polys = [4 * swizzle_chunk(2 * t + h, shift) for h in (0, 1)]
    fills = [4 * (((base + t) & ~63) | swizzle_chunk((base + t) & 63, shift))
             for base in (0, 32, 64)]
    return polys + fills


# --- the tests ----------------------------------------------------------------

def test_layout_constants_are_the_kernels():
    """The stride layout holds t + 32 j; each swap exchanges a register
    bit with a lane bit; the last leaves lane t holding 8t .. 8t + 7; the
    forward and the inverse bring every coefficient bit into a register
    (the rule the kernel's recursion follows)."""
    t, j = np.arange(LANES)[:, None], np.arange(REGS)[None, :]
    assert np.array_equal(layout_after(0).coeff(), t + 32 * j)
    assert SWAPS == len(SWAP_REG) == len(SWAP_LANE)
    for s in range(SWAPS + 1):
        lay = layout_after(s)
        assert sorted(lay.reg + lay.lane) == list(range(8))
    assert np.array_equal(np.sort(FINAL.coeff(), axis=1), 8 * t + j)
    assert 0 < MAX_RANK <= 8


@functools.lru_cache(maxsize=None)
def _jax_pipeline(scheme):
    return SCHEMES[scheme][1].make_pipeline()


def _jax(scheme, fn, *args):
    out = _jax_pipeline(scheme)[fn](*(np.asarray(a, np.uint32) for a in args))
    return np.asarray(out).astype(np.int64)


def _inputs(sch, shape, seed):
    return np.random.default_rng([seed, sch.q, *shape]).integers(
        0, sch.q, shape)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_model_transforms_match_plain_and_reference(scheme, inverse):
    """The model's transforms, raw, against the port's layered_plain and
    the JAX package's transforms (its jitted pipeline's ntt / intt, the
    module's kyber_ntt ... under jit)."""
    sch = SCHEMES[scheme][0].SCHEME
    x = _inputs(sch, (3, 256), 1)
    model = Model(sch)
    got = model.intt(x) if inverse else model.ntt(x)
    plain = LR.layered_plain(torch.from_numpy(x.astype(np.int32)), sch,
                             inverse=inverse).numpy().astype(np.int64)
    assert np.array_equal(got, plain)
    assert np.array_equal(got, _jax(scheme, "intt" if inverse else "ntt", x))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_shared_accesses_take_one_wavefront_a_phase(scheme):
    """Every shared-memory access of the model's transforms and product:
    the zeta runs of each layer both ways, ML-KEM's gamma runs, the
    shared matrix's and the transformed vectors' chunks and the matrix's
    fill take one wavefront a phase of 128 bytes."""
    sch = SCHEMES[scheme][0].SCHEME
    model = Model(sch)
    x = _inputs(sch, (1, 256), 2)
    model.intt(model.ntt(x))
    model.product(x.reshape(1, 1, 256), x.reshape(1, 1, 256), "pointwise")
    assert len(model.accesses) == 2 * sch.n_layers + bool(sch.gammas)
    for what, first, words in model.accesses:
        assert wavefronts(first, words) == [1] * words, what
    for first in smem_poly_accesses():
        assert wavefronts(first, 4) == [1] * 4


def test_swizzle_is_what_removes_the_conflicts():
    """Without the chunk swizzle a lane's two 16-byte reads of a
    polynomial take two wavefronts a phase: the model sees conflicts."""
    plain = smem_poly_accesses(shift=31)
    assert all(wavefronts(first, 4) == [2] * 4 for first in plain[:2])


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_fused_model_matches_reference_pipelines(scheme, batch):
    """The fused kernel's model, raw, against the JAX package's jitted
    make_pipeline callables: polymul, basemul / pointwise, matvec with a
    shared and with a batched matrix, serving_step (fresh A, batched) and
    make_serving_step (NTT-domain A shared by the batch)."""
    sch = SCHEMES[scheme][0].SCHEME
    k, l = SERVING[scheme]
    model = Model(sch)
    a, b = _inputs(sch, (2, batch, 256), 3)
    A = _inputs(sch, (k, l, 256), 4)
    Ab = _inputs(sch, (batch, k, l, 256), 5)
    xs = _inputs(sch, (batch, l, 256), 6)

    def vec(v):
        return v.reshape(batch, 1, 256)

    got = model.product(vec(a), b.reshape(batch, 1, 1, 256), "product")
    assert np.array_equal(got.reshape(batch, 256), _jax(scheme, "polymul",
                                                        a, b))
    got = model.product(vec(a), b.reshape(batch, 1, 1, 256), "pointwise")
    assert np.array_equal(got.reshape(batch, 256), _jax(scheme, "pointwise",
                                                        a, b))
    assert np.array_equal(model.product(xs, A, "matvec"),
                          _jax(scheme, "matvec", A, xs))
    assert np.array_equal(model.product(xs, Ab, "matvec"),
                          _jax(scheme, "matvec", Ab, xs))
    assert np.array_equal(model.product(xs, Ab, "serve_fresh"),
                          _jax(scheme, "serving_step", Ab, xs))
    A_hat = _jax(scheme, "ntt", A)
    step = _jax_pipeline(scheme)["make_serving_step"](A_hat.astype(np.uint32))
    want = np.asarray(step(xs.astype(np.uint32))).astype(np.int64)
    assert np.array_equal(model.product(xs, A_hat, "serve"), want)
