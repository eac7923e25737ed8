"""The Goldilocks arithmetic of the CUDA kernels, limb by limb, on the CPU.

``csrc/gl_arith.cuh`` writes gl_add, gl_sub and gl_mul (p = 2^64 - 2^32 +
1, canonical values) as inline PTX: chains of 32-bit instructions whose
carries and borrows pass through the carry flag. No CUDA compiler runs
here, so this file reads each function's instruction list and operand list
out of the header and runs them, one instruction at a time, on Python ints
masked to 32 bits, with the carry flag as PTX defines it (``.cc`` writes it:
the carry out of an add, the borrow out of a subtract; ``addc`` adds it,
``subc`` subtracts it). It holds the results against exact ``(a * b) % p``
and ``(a +- b) % p`` and against ``ops.modops``'s Goldilocks functions, at
the edges (0, 1, 2^32 - 1 = eps, 2^32, p - 1, p - 2^32, values at and above
2^63) and at hypothesis's random pairs.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M

P = tF.GOLDILOCKS.p
EPS = (1 << 32) - 1
MASK = (1 << 32) - 1
SRC = (C.CSRC_DIR / "gl_arith.cuh").read_text()
EDGES = [0, 1, 2, EPS, 1 << 32, (1 << 32) + 1, P - (1 << 32), P - 2, P - 1,
         1 << 63, (1 << 63) + 1, (1 << 63) + EPS, P - EPS - 1,
         0x123456789ABCDEF0]
OPS = {"gl_add": lambda a, b: (a + b) % P,
       "gl_sub": lambda a, b: (a - b) % P,
       "gl_mul": lambda a, b: a * b % P}


def _split_top(text):
    """Split at commas outside parentheses."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += ch == "("
        depth -= ch == ")"
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()] if cur.strip() else out


def read_asm(fn):
    """(instructions, outputs, inputs) of the one asm statement in the
    header's function fn: the PTX statements in order, the output
    variables' names, the input operands' C expressions."""
    body = SRC[SRC.index(f"uint64_t {fn}(uint64_t a, uint64_t b) {{"):]
    body = body[:body.index("\n}\n")]
    start = body.index("asm(") + 4
    depth, end = 1, start
    while depth:  # the asm statement's closing parenthesis
        depth += {"(": 1, ")": -1}.get(body[end], 0)
        end += 1
    text, outs, ins = body[start:end - 1].split(":")
    ptx = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', text))
    ptx = ptx.replace("\\n", "\n").replace("\\t", " ")
    stmts = [s.strip() for s in ptx.replace("{", ";").replace("}", ";")
             .split(";") if s.strip()]
    outputs = [re.fullmatch(r'"=&?r"\((\w+)\)', o).group(1)
               for o in _split_top(outs)]
    inputs = [re.fullmatch(r'"r"\((.*)\)', i).group(1)
              for i in _split_top(ins)]
    return stmts, outputs, inputs


def _c_value(expr, a, b):
    """A uint32 input operand's C expression on a and b."""
    expr = expr.replace("(uint32_t)", "0xFFFFFFFF & ")
    expr = re.sub(r"\b(0x[0-9A-Fa-f]+|\d+)u\b", r"\1", expr)
    return eval(expr, {}, {"a": a, "b": b}) & MASK  # noqa: S307


def run_asm(fn, a, b):
    """fn(a, b) as the header's PTX computes it, instruction by
    instruction; returns (hi << 32) | lo of its two outputs."""
    stmts, outputs, inputs = read_asm(fn)
    ops = [None] * len(outputs) + [_c_value(e, a, b) for e in inputs]
    regs = {}
    cf = 0

    def get(x):
        if x.startswith("%"):
            return ops[int(x[1:])]
        return regs[x]

    def put(x, v):
        if x.startswith("%"):
            ops[int(x[1:])] = v
        else:
            regs[x] = v

    for s in stmts:
        if s.startswith(".reg"):
            continue
        op, args = s.split(None, 1)
        d, *src = [t.strip() for t in args.split(",")]
        if op == "selp.b32":
            put(d, get(src[0]) if regs[src[2]] else get(src[1]))
            continue
        v = [get(x) for x in src]
        if op == "setp.ne.u32":
            regs[d] = v[0] != v[1]
            continue
        base, cc = op.removesuffix(".u32"), op.endswith(".cc.u32")
        base = base.removesuffix(".cc")
        if base in ("add", "addc"):
            t = v[0] + v[1] + (cf if base == "addc" else 0)
            r, flag = t & MASK, t >> 32
        elif base in ("sub", "subc"):
            t = v[0] - v[1] - (cf if base == "subc" else 0)
            r, flag = t & MASK, int(t < 0)
        elif base == "mul.lo":
            r, flag = (v[0] * v[1]) & MASK, None
        elif base == "mul.hi":
            r, flag = (v[0] * v[1]) >> 32, None
        elif base in ("mad.lo", "madc.hi"):
            prod = v[0] * v[1]
            part = prod & MASK if base == "mad.lo" else prod >> 32
            t = part + v[2] + (cf if base == "madc.hi" else 0)
            r, flag = t & MASK, t >> 32
        else:
            raise AssertionError(f"no model of {op}")
        assert 0 <= r <= MASK
        if not cc and flag:  # an add without .cc may not overflow
            assert base not in ("add", "addc", "mad.lo", "madc.hi"), s
        put(d, r)
        if cc:
            cf = flag
    lo, hi = ops[outputs.index("lo")], ops[outputs.index("hi")]
    return (hi << 32) | lo


def test_header_has_the_three_chains():
    for fn in OPS:
        stmts, outputs, inputs = read_asm(fn)
        assert outputs == ["lo", "hi"] and len(stmts) > 3, fn
    # the product is formed once: four partial products, two halves each
    stmts = read_asm("gl_mul")[0]
    assert sum(s.startswith(("mul.", "mad.", "madc.")) for s in stmts) == 8
    code = "\n".join(line.split("//")[0] for line in SRC.splitlines())
    assert "__umul64hi" not in code and "if (" not in code


@pytest.mark.parametrize("fn", sorted(OPS))
@pytest.mark.parametrize("a", EDGES)
def test_edges_are_exact(fn, a):
    for b in EDGES:
        assert run_asm(fn, a, b) == OPS[fn](a, b), (fn, hex(a), hex(b))


canonical = st.integers(min_value=0, max_value=P - 1)
high = st.integers(min_value=1 << 63, max_value=P - 1)


@pytest.mark.parametrize("fn", sorted(OPS))
@settings(max_examples=400, deadline=None, database=None)
@given(a=canonical, b=canonical)
def test_random_pairs_are_exact(fn, a, b):
    assert run_asm(fn, a, b) == OPS[fn](a, b)


@pytest.mark.parametrize("fn", sorted(OPS))
@settings(max_examples=200, deadline=None, database=None)
@given(a=high, b=st.one_of(high, canonical))
def test_high_values_are_exact(fn, a, b):
    assert run_asm(fn, a, b) == OPS[fn](a, b)


@pytest.mark.parametrize("fn", sorted(OPS))
def test_matches_modops(fn):
    """The header's chains and the plain version's gl_* (int64 limb
    carriers) on the same random and edge pairs."""
    rng = np.random.default_rng(len(fn))
    a = np.concatenate([rng.integers(0, P, 200, dtype=np.uint64),
                        np.repeat(np.array(EDGES, dtype=np.uint64),
                                  len(EDGES))])
    b = np.concatenate([rng.integers(0, P, 200, dtype=np.uint64),
                        np.tile(np.array(EDGES, dtype=np.uint64),
                                len(EDGES))])
    limbs = [M.to_carrier(v) for v in
             (*M.gl_from_u64(a, "cpu"), *M.gl_from_u64(b, "cpu"))]
    hi, lo = getattr(M, fn)(*limbs)
    want = M.gl_to_u64(M.from_carrier(hi), M.from_carrier(lo)).tolist()
    got = [run_asm(fn, int(x), int(y)) for x, y in zip(a, b)]
    assert got == want
