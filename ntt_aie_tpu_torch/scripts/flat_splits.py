"""Time the internal splits of the flat plans on the card.

A flat configuration (``NTTConfig.split`` = (n, 1)) runs the four-step
kernels at ``plan.flat_inner_split(log_n)`` and then gathers the spectrum
into bit-reversed order (``twiddles.flat_gather``). This script times,
for a few flat sizes and every (n1, n2) it lists, the fold plan's
cp2 . cp1 and the fused transform at that split, and the gather, as us
per NTT on CUDA events (``utils.timing.time_device``), two readings each
in turns; one JSON line a reading, after the card's name and power limit.

    python -m ntt_aie_tpu_torch.scripts.flat_splits

Needs a CUDA device (it builds the kernels at first use).
"""

import json
import subprocess
import sys

import torch

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.plan import fold_passes, fused_passes
from ntt_aie_tpu_torch.utils.timing import time_device

# (field name, log_n, batch, the (n1, n2) splits to time): chip_smoke.py's
# flat shapes (F1, F2, F3, route (a)'s n = 2^12, F5) and the sizes between
CASES = [("p469762049", 16, 256, [(64, 1024), (128, 512), (256, 256),
                                   (512, 128), (1024, 64)]),
         ("p469762049", 14, 1024, [(32, 512), (64, 256), (128, 128),
                                    (256, 64), (512, 32)]),
         ("p469762049", 12, 4096, [(32, 128), (64, 64), (128, 32)]),
         ("p469762049", 10, 16384, [(8, 128), (16, 64), (32, 32), (64, 16),
                                     (128, 8)]),
         ("kyber", 8, 16384, [(8, 32), (16, 16), (32, 8)]),
         ("dilithium", 8, 16384, [(8, 32), (16, 16), (32, 8)]),
         ("goldilocks", 14, 256, [(64, 256), (128, 128), (256, 64)]),
         ("goldilocks", 12, 1024, [(32, 128), (64, 64), (128, 32)])]


def reading(dev, gen, name, log_n, B, n1, n2) -> dict:
    """One reading of one split: us per NTT of the fold and fused
    transforms (fused: None for Goldilocks) and of the gather."""
    field = T.FIELDS[name]
    n = 1 << log_n
    gl = field.is_goldilocks
    if gl:
        x = tuple(torch.randint(0, 1 << 31, (B, n1, n2), dtype=torch.int32,
                                device=dev, generator=gen)
                  for _ in range(2))
        ps = gl_fold_passes(field, n1, n2, device=dev)

        def fold(v):
            return tuple(t.reshape(B, n1, n2)
                         for t in ps["cp2"](ps["cp1"](v)))

        fused_us = None
    else:
        x = torch.randint(0, field.p, (B, n1, n2), dtype=torch.int32,
                          device=dev, generator=gen)
        kind = T.NTTConfig(field=field, log_n=log_n).resolved_reduction
        ps = fold_passes(field, n1, n2, reduction=kind, device=dev)
        ff = fused_passes(field, n1, n2, reduction=kind, device=dev)["ff"]

        def fold(v):
            return ps["cp2"](ps["cp1"](v)).reshape(B, n1, n2)

        fused_us = time_device(lambda v: ff(v).reshape(B, n1, n2),
                               x)["us_per_iter"] / B
    fold_us = time_device(fold, x)["us_per_iter"] / B
    g = torch.from_numpy(tw.flat_gather(n1, n2)).to(dev)
    xf = tuple(t.reshape(B, n) for t in x) if gl else x.reshape(B, n)

    def take(v):
        if gl:
            return tuple(t.index_select(1, g) for t in v)
        return v.index_select(1, g)

    gather_us = time_device(take, xf)["us_per_iter"] / B
    return {"fold_us_per_ntt": fold_us, "fused_us_per_ntt": fused_us,
            "gather_us_per_ntt": gather_us}


def main() -> int:
    if not torch.cuda.is_available():
        print("flat_splits: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    C.build_libraries()
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, log_n, B, splits in CASES:
        for rep in range(2):
            for n1, n2 in splits:
                out = reading(dev, gen, name, log_n, B, n1, n2)
                print(json.dumps(dict({"field": name, "n": 1 << log_n,
                                       "batch": B, "split": [n1, n2],
                                       "reading": rep, "card": card},
                                      **out)), flush=True)
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
