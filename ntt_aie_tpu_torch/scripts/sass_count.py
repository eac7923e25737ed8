"""What the CUDA compiler made of the port's kernels, read from their SASS.

    python -m ntt_aie_tpu_torch.scripts.sass_count [--root NAME=DIR ...]
        [--loops SUBSTRING] LIBRARY ...

Builds each named library (``csrc/<LIBRARY>.cu``, or LIBRARY:REDUCTION
for a source built once a reduction, such as ``colpass:montgomery``; the
root must know that reduction) of each root — this
checkout is the root "this"; another is a directory that holds
``ntt_aie_tpu_torch/``, such as an unpacked ``git archive`` of another
commit — with that root's own ``ops.colpass.build_library``, disassembles
it with ``cuobjdump -sass`` and prints one JSON line per root and library:

  - ``sha``: per kernel (mangled name), a hash of its instruction text
    (addresses and encodings dropped), so two roots' kernels can be
    compared instruction for instruction;
  - ``instructions``: per kernel, its count of instructions;
  - ``loops``: for each kernel whose name holds SUBSTRING, every loop (a
    branch back to a lower address) with its instructions and their
    opcodes, innermost first.

Then one summary line: for each library (``compare``), the kernels that
every root has whose hash differs between roots ("differ"), the kernels
only some roots have, by root, whose hash every other root has under
another name ("renamed": a template parameter added to a kernel renames
each of its instantiations) or not ("unmatched"); and the card's name and
power limit. Needs nvcc and cuobjdump (``CUDA_HOME``); a card is not
used.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

THIS_ROOT = pathlib.Path(__file__).resolve().parents[2]
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def _tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", name)
    return path if os.path.exists(path) else (shutil.which(name) or name)


def _build(root: pathlib.Path, lib: str) -> str:
    """The path of root's built csrc/<lib>.cu (lib: NAME or
    NAME:REDUCTION)."""
    name, _, red = lib.partition(":")
    call = f"{name!r}, {red!r}" if red else repr(name)
    code = ("from ntt_aie_tpu_torch.ops import colpass as C; "
            f"print(C.build_library({call}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root,  # -c puts cwd first on sys.path
                         env=dict(os.environ, PYTHONPATH=str(root)),
                         check=True)
    return res.stdout.strip().splitlines()[-1]


def parse_sass(text: str) -> dict:
    """{kernel: [(address, instruction text)]} of cuobjdump -sass output.
    A kernel in an anonymous namespace is named without the namespace's
    tag, which hashes the source file and differs between checkouts."""
    kernels, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_[0-9a-f]{8}(?=\d)", "_GLOBAL__N_",
                          m.group(1))
            cur = kernels.setdefault(name, [])
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return kernels


def loops(insns: list) -> list:
    """Every loop of one kernel (a BRA to a lower address), innermost
    first: its first and last address, its instruction count and its
    opcodes (predicates dropped)."""
    out = []
    for addr, text in insns:
        m = _BRA.search(text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        body = [t for a, t in insns if start <= a <= addr]
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in body)
        out.append({"start": hex(start), "end": hex(addr),
                    "instructions": len(body),
                    "ops": dict(ops.most_common())})
    return sorted(out, key=lambda lp: lp["instructions"])


def compare(by_root: dict) -> dict:
    """The summary of one library from {root: {kernel: hash}}: "differ",
    "renamed" and "unmatched" (see the top)."""
    common = set.intersection(*(set(sha) for sha in by_root.values()))
    differ = sorted(k for k in common
                    if len({sha[k] for sha in by_root.values()}) > 1)
    renamed, unmatched = {}, {}
    for root, sha in by_root.items():
        others = [set(o.values()) for r, o in by_root.items() if r != root]
        for k in sorted(set(sha) - common):
            into = renamed if all(sha[k] in o for o in others) else unmatched
            into.setdefault(root, []).append(k)
    return {"differ": differ, "renamed": renamed, "unmatched": unmatched}


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("libraries", nargs="+", metavar="LIBRARY")
    ap.add_argument("--root", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout")
    ap.add_argument("--loops", default=None, metavar="SUBSTRING",
                    help="list the loops of the kernels whose name holds it")
    args = ap.parse_args(argv)
    roots = {}
    for spec in args.root:
        name, _, path = spec.partition("=")
        if not path or not (pathlib.Path(path) / "ntt_aie_tpu_torch").is_dir():
            ap.error(f"--root {spec}: not NAME=DIR of a checkout")
        roots[name] = pathlib.Path(path).resolve()
    roots["this"] = THIS_ROOT

    shas = collections.defaultdict(dict)
    for name, root in roots.items():
        for lib in args.libraries:
            so = _build(root, lib)
            sass = subprocess.run([_tool("cuobjdump"), "-sass", so],
                                  capture_output=True, text=True, check=True)
            kernels = parse_sass(sass.stdout)
            sha = {k: hashlib.sha256("\n".join(t for _, t in v).encode())
                   .hexdigest()[:16] for k, v in kernels.items()}
            shas[lib][name] = sha
            line = {"root": name, "library": lib, "sha": sha,
                    "instructions": {k: len(v) for k, v in kernels.items()}}
            if args.loops:
                line["loops"] = {k: loops(v) for k, v in kernels.items()
                                 if args.loops in k}
            print(json.dumps(line), flush=True)
    summary = {lib: compare(by_root) for lib, by_root in shas.items()}
    print(json.dumps({"summary": {"libraries": summary,
                                  "roots": list(roots)},
                      "card": _card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
