"""ctypes binding to the native C++ golden oracle (native/oracle.cc).

A jax-free twin of ``ntt_aie_tpu.native_oracle``: the forward DIF (one
vector or a batch), the inverse DIT, the cyclic and negacyclic products,
the O(n^2) schoolbook negacyclic product (the gate of the ML-KEM ring,
which has no 2n-th root), the reference device's network, power table and
16-block placement (the parity gate), and the scalar modular multiplies
(Barrett, Montgomery, Goldilocks and its 128-bit reduction). The library builds on demand with ``make -C native`` (g++
only, no deps). ``write_vectors`` and ``run_verify_gate`` drive the
standalone gate ``native/nttverify`` (``native/verify_main.cc``), which
re-derives a claimed result in a process of its own.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libnttoracle.so"


class NativeOracleUnavailable(RuntimeError):
    pass


@functools.cache
def load() -> ctypes.CDLL:
    """Build (make is dependency-checked, so a no-op when current) and
    load the native oracle library."""
    if not (_NATIVE_DIR / "Makefile").exists():
        raise NativeOracleUnavailable(
            f"native sources not found at {_NATIVE_DIR}")
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR), "libnttoracle.so"],
                       check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        if not _LIB_PATH.exists():
            raise NativeOracleUnavailable(f"native build failed: {e}") from e
    lib = ctypes.CDLL(str(_LIB_PATH))
    u64, u32, i64 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64
    pu64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.ntt_barrett_mulmod.restype = u32
    lib.ntt_barrett_mulmod.argtypes = [u32, u32, u32, u32, u32]
    lib.ntt_mont_mulmod.restype = u32
    lib.ntt_mont_mulmod.argtypes = [u32, u32, u32, u32]
    lib.ntt_goldilocks_mulmod.restype = u64
    lib.ntt_goldilocks_mulmod.argtypes = [u64, u64]
    lib.ntt_goldilocks_reduce128.restype = u64
    lib.ntt_goldilocks_reduce128.argtypes = [u64, u64]
    lib.ntt_reference_network.restype = None
    lib.ntt_reference_network.argtypes = [pi64, i64, pi64, i64, i64]
    lib.ntt_make_power_table.restype = None
    lib.ntt_make_power_table.argtypes = [pi64, i64, i64, i64]
    lib.ntt_block_permute16.restype = None
    lib.ntt_block_permute16.argtypes = [pi64, pi64, i64]
    lib.ntt_dif_u64.restype = None
    lib.ntt_dif_u64.argtypes = [pu64, i64, u64, u64]
    lib.ntt_dit_u64.restype = None
    lib.ntt_dit_u64.argtypes = [pu64, i64, u64, u64, ctypes.c_int]
    lib.ntt_dif_u64_batch.restype = None
    lib.ntt_dif_u64_batch.argtypes = [pu64, i64, i64, u64, u64]
    lib.ntt_cyclic_polymul_u64.restype = None
    lib.ntt_cyclic_polymul_u64.argtypes = [pu64, pu64, pu64, i64, u64, u64]
    lib.ntt_negacyclic_polymul_u64.restype = None
    lib.ntt_negacyclic_polymul_u64.argtypes = [pu64, pu64, pu64, i64, u64,
                                               u64]
    lib.ntt_schoolbook_negacyclic_u64.restype = None
    lib.ntt_schoolbook_negacyclic_u64.argtypes = [pu64, pu64, pu64, i64, u64]
    return lib


def reference_network(a, table, p: int,
                      stages: int | None = None) -> np.ndarray:
    """The reference device's butterfly network (increasing stride, GS
    butterflies against table[h+i]) on a length-n vector; stages: run
    stages 0..stages inclusive, None full depth."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.int64).copy()
    table = np.ascontiguousarray(table, dtype=np.int64)
    lib.ntt_reference_network(a, len(a), table, p,
                              len(a) if stages is None else stages)
    return a


def make_power_table(n: int, p: int, g: int) -> np.ndarray:
    """t[i] = w^i with w = g^((p-1)/n), floor division (the reference
    device's make_roots)."""
    lib = load()
    out = np.empty(n, dtype=np.int64)
    lib.ntt_make_power_table(out, n, p, g)
    return out


def block_permute16(a) -> np.ndarray:
    """The reference device's 16-block output placement."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.int64)
    out = np.empty_like(a)
    lib.ntt_block_permute16(a, out, len(a))
    return out


def schoolbook_negacyclic(a, b, p: int) -> np.ndarray:
    """The O(n^2) schoolbook product mod (X^n + 1, p): no NTT on the
    oracle's path."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    c = np.empty_like(a)
    lib.ntt_schoolbook_negacyclic_u64(a, b, c, len(a), p)
    return c


def ntt_dif(a, omega: int, p: int) -> np.ndarray:
    """Forward DIF of one length-n vector: natural in, bit-reversed out."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint64).copy()
    lib.ntt_dif_u64(a, len(a), omega, p)
    return a


def ntt_dit(a, omega: int, p: int, scale: bool = False) -> np.ndarray:
    """DIT of one length-n vector: bit-reversed in, natural out; with
    scale=True times 1/n (the inverse transform, given omega^-1)."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint64).copy()
    lib.ntt_dit_u64(a, len(a), omega, p, 1 if scale else 0)
    return a


def ntt_dif_batch(a, omega: int, p: int) -> np.ndarray:
    """Batched forward DIF (natural in, bit-reversed out) over the rows of
    a (B, n) array, in one C call."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint64).copy()
    B, n = a.shape
    lib.ntt_dif_u64_batch(a, B, n, omega, p)
    return a


def cyclic_polymul(a, b, omega: int, p: int) -> np.ndarray:
    """c = a * b mod (X^n - 1, p) for length-n vectors."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    c = np.empty_like(a)
    lib.ntt_cyclic_polymul_u64(a, b, c, len(a), omega, p)
    return c


def negacyclic_polymul(a, b, psi: int, p: int) -> np.ndarray:
    """c = a * b mod (X^n + 1, p) for length-n vectors; psi is a primitive
    2n-th root of unity."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    c = np.empty_like(a)
    lib.ntt_negacyclic_polymul_u64(a, b, c, len(a), psi, p)
    return c


def barrett_mulmod(a: int, b: int, p: int, w: int, u: int) -> int:
    """a b mod p by the oracle's Barrett reduction (w, u: the field's
    barrett_w and barrett_u)."""
    return int(load().ntt_barrett_mulmod(a, b, p, w, u))


def mont_mulmod(a: int, b: int, p: int, neg_pinv: int) -> int:
    """a b R^-1 mod p, R = 2^32, by the oracle's Montgomery REDC."""
    return int(load().ntt_mont_mulmod(a, b, p, neg_pinv))


def goldilocks_mulmod(a: int, b: int) -> int:
    """a b mod 2^64 - 2^32 + 1."""
    return int(load().ntt_goldilocks_mulmod(a, b))


def goldilocks_reduce128(x: int) -> int:
    """A 128-bit x mod 2^64 - 2^32 + 1."""
    return int(load().ntt_goldilocks_reduce128(x >> 64, x & ((1 << 64) - 1)))


# ---- the standalone verification gate (native/verify_main.cc) ----

_BIN_PATH = _NATIVE_DIR / "nttverify"

# the vector file's kind codes (native/verify_main.cc)
_KINDS = {"forward": 0, "cyclic_polymul": 1, "negacyclic_polymul": 2,
          "negacyclic_schoolbook": 3}


def write_vectors(path, kind: str, p: int, n: int, root: int, a, claimed,
                  b=None) -> None:
    """Write a .nttv vector file for nttverify: the magic "NTTV", then
    (version 1, kind, p, n, root) little-endian, the input a, the second
    operand b of a product, and the claimed result, each n uint64
    (native/verify_main.cc documents the format)."""
    import struct

    with open(path, "wb") as f:
        f.write(b"NTTV")
        f.write(struct.pack("<IIQQQ", 1, _KINDS[kind], p, n, root))
        f.write(np.ascontiguousarray(a, dtype=np.uint64).tobytes())
        if b is not None:
            f.write(np.ascontiguousarray(b, dtype=np.uint64).tobytes())
        f.write(np.ascontiguousarray(claimed, dtype=np.uint64).tobytes())


def run_verify_gate(path) -> bool:
    """Run the separately compiled gate native/nttverify on a vector file
    and return True on PASS. It runs ``make -C native nttverify`` first
    (dependency-checked, so a no-op when current), so a stale binary never
    serves as the independent gate; a failed build raises
    NativeOracleUnavailable. The binary's mismatch report is printed."""
    if not (_NATIVE_DIR / "Makefile").exists():
        raise NativeOracleUnavailable(
            f"native sources not found at {_NATIVE_DIR}")
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR), "nttverify"],
                       check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        raise NativeOracleUnavailable(f"nttverify build failed: {e}") from e
    res = subprocess.run([str(_BIN_PATH), str(path)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        if res.stdout:
            print(res.stdout.strip())
        if res.stderr:
            print(res.stderr.strip())
    return res.returncode == 0
