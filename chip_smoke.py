#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

It drives the port's paths through their CUDA kernels and exits
non-zero at the first failure: the n = 2^20 forward NTT over p = 469762049
as ``build_plan(...).make_batched(256)["fwd_mat"]``, its inverse and the
cyclic product (the column-pass kernel); the same at n = 2^20 over
Goldilocks p = 2^64 - 2^32 + 1 at B = 64 (the Goldilocks column-pass
kernel and the pointwise Goldilocks product); the fused plan
``build_plan(..., fused=True)`` at n = 2^20 over p = 469762049 with its
negacyclic product (the fused four-step kernel); and the nested R x S
column pass's check and bench at 1024 x 1024 (``python -m
ntt_aie_tpu_torch.scripts.proto_nested_colpass``: the nested kernel, the
column-pass kernel and the butterfly probe), with the roofline probes; and
the fold and fused plans under the other three reductions (the column-pass
and fused kernels' libraries of each): montgomery at n = 2^20 over
p = 2013265921, harvey at n = 2^20 over p = 998244353, both at B = 256, and
barrett at n = 256 over Kyber's p = 3329 on the 16 x 16 split at
B = 16,384; and the flat split (NTTConfig's default for a single shard up
to n = 2^16, 2^14 for Goldilocks: the four-step kernels at an internal
split, then one gather into bit-reversed order), F1-F5 of FLAT_PLANS;
and the column kernel's 'pre' and 'post' operands: the negacyclic
product on the fold plan, the wmat_fold=False arm, and exact RNS products
with the CRT combine kernel; and the column kernels' factored and rank-1
operands: the wmat_factored=True plans (32-bit and Goldilocks) and the
Goldilocks wmat_fold=False plan; n = 2 on the flat split; the ML-KEM and
ML-DSA rings with their serving pipelines (the FIPS layered-transform
kernel, csrc/ring_layers.cu); and the reference-parity plan; the
distributed four-step plan; and the entry points a user calls: the
command line (python -m ntt_aie_tpu_torch), torch.profiler traces, the
sweep and scaling harnesses and host streaming; and the five worked
examples (python -m ntt_aie_tpu_torch.examples.<name>); and the
tall route of the column passes at BabyBear's and Goldilocks's largest
transforms (n = 2^27, 2^28).
Phases, one JSON object per line:

  1. env       — the card (nvidia-smi's name and power limit, also printed
                 as its own line), torch and CUDA versions;
  2. build     — compiles every csrc/*.cu (colpass, gl_colpass,
                 fused_fourstep, nested_colpass, bfly_probe, crt,
                 ring_layers, pointwise; colpass and
                 fused_fourstep once for each of harvey4, harvey,
                 montgomery and barrett) with nvcc into build/, one
                 process each, all started at once, while phases 3-4 run
                 on the harvey4 column library (the script waits for
                 that build first); its line, the seconds to the last
                 build's end, follows phase 4, before any timing;
  3. kernel    — the 32-bit kernel against its plain PyTorch version on the
                 card, bit-exact, for cp1/cp2/icp2/icp1 at the 1024x1024
                 split, 128x512, 2048x512 and 512x2048 (nested, TL 8, 16
                 and 4) and 32x64 and 64x32 (plain, TL 32), B = 1 and 4,
                 and DIF and DIT over 8,192 rows at (1, 8192, 64) (the
                 tall route's two launches);
  4. slice     — fwd_mat on a 1 GiB int32 batch (B = 256) gated against the
                 native C++ oracle on row 0 plus 8 random rows (the NumPy
                 oracle if the library cannot build); inv_mat(fwd_mat(x)) ==
                 x on the whole batch; polymul_mat against the NumPy cyclic
                 product; kernel launch counts 2 / 2 / 6 column passes
                 and 0 / 0 / 1 pointwise products;
  5. time      — us/NTT of fwd_mat through the kernel and through the plain
                 version, and us/pass of cp1 and cp2, on CUDA events; the
                 column kernel's kernel_info for cp1 and cp2 (register
                 group size, tile layout and width, registers, blocks per
                 SM);
  6. gl_kernel — the Goldilocks kernel against its plain version for
                 cp1/cp2/icp2/icp1 at 1024x1024, 128x512 and 2048x256, B = 4,
                 and DIF and DIT over 8,192 rows at (1, 8192, 64), as the
                 whole-column launch (2-column tiles) and as the plans'
                 tall route, both limb planes bit-exact, at the register
                 group size the build compiles (kernel_info's kfuse, on
                 each line); the pointwise product kernel against its
                 plain version on random values and the edges;
  7. gl_slice  — Goldilocks fwd_mat on a B = 64 batch (512 MiB per limb
                 pair) gated against the native oracle on row 0 plus 8
                 random rows (the object-dtype NumPy oracle if the library
                 cannot build); the inv_mat roundtrip on the whole batch;
                 polymul_mat against the native cyclic product; launch
                 counts 2 / 2 / 6 column passes and 1 pointwise product;
  8. gl_time   — the same timings for the Goldilocks path, and the
                 pointwise product's; the Goldilocks column kernel's
                 kernel_info for cp1 and cp2;
  9. fused_kernel — the fused kernel against its plain version for ff, fi
                 (no operands), nf ('pre') and ni ('post') at 1024x1024,
                 512x2048, 2048x512, 32x64 and 64x32, B = 1 and 4,
                 bit-exact; and again after a chain of ten launches of the
                 same transform at B = 1 and 4 in turn, with phase A's tile
                 counter back at zero;
 10. fused_slice — the fused plan (negacyclic=True): fwd_mat at B = 1 and
                 B = 256 equal to the fold plan's and gated against the
                 native oracle on row 0 plus 8 random rows; the inv_mat
                 roundtrip on the whole batch; polymul_mat against the
                 native cyclic product; negacyclic_polymul_mat (B = 2)
                 against the native negacyclic product and a direct O(n)
                 sum at 8 random coefficients; fused launches 1 / 1 / 1 /
                 3 / 3, 32-bit pointwise products 0 / 0 / 0 / 1 / 1 and
                 no column-pass launch;
 11. fused_time — us/NTT of the fused fwd_mat and inv_mat at B = 1 and
                 256, beside the fold plan's (timed in turns: fold, fused,
                 fused, fold) and the plain fused version's at B = 1 and
                 256; the fused kernel's register group size (kFuse), its
                 registers and blocks per SM and its grid at B = 256; then,
                 after those timed chains, the fused fwd_mat at B = 256
                 against the fold plan's and the inv_mat roundtrip;
 12. nested_kernel — the nested kernel against its plain version,
                 bit-exact: at the shapes phases 13-14 run it at (B = 64
                 1024x1024 at fuse 1 to 5, the bench's; B = 1 1024x256 at
                 fuse 3, the check's), and at B = 4 1024x1024 at fuse 1 to
                 5, 2048x512, 256x512 with R = 8 and 64x512 (R = S = 8);
                 at B = 4 and fuse 1 to 5 with an empty phase: 256x512 with
                 R = 1, 256x16 with R = 256 and 2x512 (R = 1); at
                 1024x1024 also equal to the column-pass kernel;
 13. nested_check — the script's check mode on the card;
 14. nested_bench — the script's bench mode at B = 64, chain 8: the probe
                 line, then the column-pass kernel and the nested kernel at
                 fuse 1 to 5 (us per call, Gbf/s, % of the ideal rate);
                 launch counts of phases 13-14 (nested, probe, column
                 pass); the plain nested version's and the plain probe's
                 times; the nested kernel's kernel_info at each fuse
                 (tile width, shift, registers, blocks per SM);
 15. roofline  — measure_peak, then measure_vpu_peak for harvey4 and
                 Goldilocks at r = 64 and 128 and for harvey, montgomery
                 (p = 998244353) and barrett (p = 3329) at r = 64, and the
                 probe kernel's values against its plain version at
                 r = 64;
 16. batch_split — the 32-bit, Goldilocks and nested column kernels at a
                 batch of 65,537 (two launches each: one launch takes 65,535
                 batch rows) on a 32-row column, against their plain
                 versions, bit-exact;
 17. red_kernel — for montgomery, harvey and barrett, the column kernel
                 against its plain version, raw and bit-exact, on inputs
                 in the reduction's domain: cp1/cp2/icp2/icp1 at
                 1024x1024 (nested) and 32x64 (plain, TL 32), barrett at
                 16x16 (the Kyber split; p = 3329 has no larger one) and
                 16x8; and the fused kernel's ff/fi/nf/ni at the same shapes
                 (barrett's nf/ni at 16x8 only: n = 128 is the largest
                 negacyclic size of p = 3329), B = 1 and 4;
 18. red_slice — the three plans at full width, fold and fused:
                 fwd_mat gated against the native oracle on row 0 plus 8
                 random rows, the fused fwd_mat equal to the fold plan's,
                 inv_mat(fwd_mat(x)) == x on the whole batch,
                 polymul_mat (B = 2) against the native cyclic product on
                 both rows, the fused negacyclic_polymul_mat (B = 2;
                 barrett at n = 128) against the native negacyclic
                 product; launch counts 2 / 2 / 6 column passes (fold)
                 and 1 / 1 / 3 / 3 fused launches, and one 32-bit
                 pointwise product a polymul_mat on each;
 19. red_time  — per reduction, us/NTT of fwd_mat, inv_mat and
                 polymul_mat of both plans, cp1 and cp2 us/pass/NTT, the
                 plain versions' at a batch of 4 (n = 2^20) or the full
                 batch (n = 256), and kernel_info of cp1, cp2 and the
                 fused ff; and harvey against harvey4 on p = 469762049
                 (fold and fused fwd_mat at B = 256, timed in turns);
 20. flat, flat_time — per FLAT_PLANS configuration (F1 p = 469762049
                 at n = 2^16, B = 256, negacyclic; F2 Kyber n = 256,
                 B = 16,384, negacyclic at n = 128; F3 Dilithium n = 256,
                 B = 16,384, negacyclic; F4 p = 2013265921 and 998244353
                 at n = 2^16, B = 64; F5 Goldilocks n = 2^14, B = 256,
                 negacyclic), the fold and fused flat plans (Goldilocks:
                 fold): the batched fwd gated bit for bit against the
                 native oracle on row 0 plus 8 random rows, inv(fwd(x))
                 == x on the whole batch, polymul and negacyclic_polymul
                 against the native products on those rows, the fused
                 fwd equal to the fold fwd, ordering='natural' equal to
                 the gathered bit-reversed output, the plain flat stage
                 loops (ops/stages.py) equal on 16 rows; launches per
                 call: fold 2 / 2 / 6 / 0 column passes and 0 / 0 / 0 /
                 3 fused launches (the negacyclic product is the fused
                 plan's on both), fused 0 / 0 / 0 / 0 and 1 / 1 / 3 / 3,
                 and 0 / 0 / 1 / 1 32-bit pointwise products on both;
                 Goldilocks 2 / 2 / 6 / 6 and 0 / 0 / 1 / 4 pointwise
                 products; then us/NTT of each callable, of the gather
                 alone, of the internal four-step alone and of the plain
                 stage loops at 16 rows; and n = 2 (FLAT_N2: p = 469762049
                 and Goldilocks at B = 4,096, no two-factor split: the
                 stage loops as torch ops): fwd, inv, polymul and
                 negacyclic_polymul batched against the native oracle on
                 row 0 plus 8 random rows, the roundtrip, the flat
                 callables on row 0, no column pass or fused launch
                 (products: 0 / 0 / 1 / 4 of the 32-bit kernel, or of
                 gl_mul for Goldilocks);
 21. flat_route_a — route (a) of the flat forward (one column pass over
                 (1, n, B), the batch as columns, after a torch
                 transpose and before the colperm -> bit-reversal
                 gather) at Kyber's n = 256, B = 16,384 and at n = 2^12,
                 B = 4,096 over p = 469762049, held equal to the plain
                 flat forward and the plan's, and timed beside the
                 plans' route (b), with its parts.
 22. gl_negacyclic — the Goldilocks negacyclic product on the four-step
                 split at n = 2^20, B = 64 (phase 7's plan with
                 negacyclic=True): the device memory its plan and batched
                 callables hold beyond the cyclic plan's (psi and psi^-1,
                 held once and broadcast over the batch by gl_mul; at most
                 16 MiB), row 0 and two random rows against the native
                 negacyclic product, launches 6 / 4, and us/NTT of
                 negacyclic_polymul beside polymul.
 23. prepost_kernel — the column kernel's instantiations with 'pre' and
                 'post' operands (PREPOST_PASSES: the fold plan's
                 negacyclic ncp1 and nicp1, the wmat_fold=False arm's
                 cp2, icp1, ncp1 and nicp1) against the plain version,
                 raw and bit-exact, under harvey4 (1024x1024, 512x2048,
                 32x64), montgomery and harvey (1024x1024, 32x64) and
                 barrett (Kyber, 16x8), B = 1 and 4; the factored and
                 rank-1 instantiations of the wmat_factored=True arm
                 (WFAC_PASSES: cp2, icp2, ncp1, nicp1) under the four
                 reductions at 1024x1024, 128x512 and the 8,192-row
                 column (Kyber 16x8), and the Goldilocks kernel's
                 (GL_ARM_PASSES: the entry arm's cp2 and icp1 with the
                 'pre' matrix, the factored cp2 and icp2) at 1024x1024,
                 2048x256 and 8,192 rows, B = 1 and 4, both planes;
 24. nega_fold, nega_fold_time — the negacyclic product on the
                 four-step fold plan (NEGA_PLANS: n = 2^20 over
                 p = 469762049 at B = 256, over p = 2013265921 and
                 998244353 at B = 64, Kyber n = 128 at B = 16,384):
                 negacyclic_polymul_mat gated against the native oracle
                 on row 0 plus 8 random rows, equal to the wmat_fold=False
                 plan's, launches 6 column passes (2 ncp1, 2 cp2, icp2,
                 nicp1), 0 fused and 1 pointwise product; at n = 2^20
                 over p = 469762049 equal to the fused plan's, and us/NTT
                 of it beside the cyclic polymul_mat and the fused
                 negacyclic product, ncp1 and nicp1 alone beside cp1 and
                 icp1, their plain versions at B = 4, kernel_info;
 25. wmat_entry, wmat_entry_time — the wmat_fold=False plan at n = 2^20,
                 B = 256 over p = 469762049 equal to the fold plan on
                 every callable (fwd_mat, inv_mat, polymul_mat,
                 negacyclic_polymul_mat and the flat four); fwd_mat and
                 inv_mat of both timed in turns, the products, and cp2,
                 icp1, ncp1, nicp1 of the entry arm alone with their plain
                 versions at B = 4 and kernel_info;
 26. rns, rns_time — RNSPolymul over the default primes (p =
                 2013265921, 998244353, 469762049) on the card (RNS_CASES:
                 n = 2^20 at B = 16, cyclic and negacyclic, n = 2^16 at
                 B = 64 negacyclic): each field's residue product on row 0
                 and 2 random rows against the native oracle, the device
                 limbs (csrc/crt.cu) against the host's object-math CRT of
                 the same residues on those rows and against the plain
                 combine on every coefficient, launches (18 column passes
                 or 9 fused launches, 3 pointwise products and 1
                 combine); RNSPolymul(10)
                 against the schoolbook integer product; the host-to-limbs
                 time of polymul_limbs, its device part and the combine
                 alone beside its byte bound.
 27. wmat_factored, wmat_factored_time — the wmat_factored=True plan at
                 n = 2^20, B = 256 over p = 469762049 (negacyclic): every
                 callable equal to the fold plan's, fwd_mat gated on the
                 native oracle on row 0 plus 8 random rows, launches by
                 instantiation 2 / 2 / 6 / 6 (cp2 'pre' wfac, icp2 'post'
                 wfac, ncp1/nicp1 rank-1 psi); fwd_mat and inv_mat in
                 turns with the fold and entry arms, the products, and
                 cp2, icp2, ncp1, nicp1 alone with their plain versions
                 at B = 4 and kernel_info; then the montgomery plan
                 (p = 2013265921, n = 2^20, B = 256) and barrett on Kyber
                 (n = 256, 16 x 16, B = 16,384) equal to their fold plans
                 on every callable (FAC_CHECKS).
 28. gl_arms, gl_arms_time — the Goldilocks wmat_fold=False and
                 wmat_factored=True plans at n = 2^20, B = 64
                 (negacyclic): every callable equal to the fold plan's,
                 fwd_mat gated on the native oracle, launches by
                 instantiation; fwd_mat of the three arms in turns, and
                 the new passes alone with their plain versions at B = 4
                 and kernel_info.
 29. pqc_kernel, pqc, pqc_time — the ML-KEM (q = 3329) and ML-DSA
                 (q = 8380417) rings: the four csrc/ring_layers.cu
                 transforms (ML-KEM and ML-DSA forward and inverse)
                 against their plain versions raw at B = 1, 3, 13 (a
                 part-filled block), 8,192 and (8, 3, 256), and the
                 seven fused ring-product instantiations a scheme
                 (PQC_PRODUCTS: polymul, pointwise, matvec and the
                 serving step with a shared and with a batched matrix,
                 the serving step with a fresh batched matrix) against
                 ring_product_plain raw at B = 1, 3, 13, (8, 3) and
                 8,192 (vectors, a shared matrix) or 1,024 (matrices);
                 each scheme's make_pipeline on the card: intt(ntt(x)) ==
                 x at B = 8,192, polymul on 8 rows against the native
                 schoolbook product, pointwise at B = 8,192, matvec,
                 make_serving_step(A_hat)(x) and serving_step(A, x) at
                 ML-KEM-768 (A 3 x 3) and ML-DSA-65 (A 6 x 5, output
                 (B, 6, 256)), B = 1,024, and matvec, the serving step
                 and serving_step with a matrix a row at B = 64, equal to
                 the plain route (the CPU), A
                 from the seeded numpy generator, launches by call
                 (PQC_LAUNCHES: one a call, serving_step with one
                 matrix two); us per call of the pipeline's calls, each
                 kernel alone (a CUDA graph of a chain of launches), the
                 plain version and the unfused route (the layered kernel
                 and torch ops, as before the fused kernel) of each
                 fused instantiation, the plain transforms at B = 8,192
                 and 64;
 30. reference_parity, reference_parity_time — the reference-parity plan:
                 the paper's configuration (Kyber, n = 2048,
                 ordering='reference', a[i] = i) equal to
                 reference.reference_device_output and to the native
                 network with block_permute16, and p = 469762049
                 (harvey4) at n = 2^20 equal to the NumPy and native
                 networks; NTTContext.forward_host equal; fwd timed.

 31-33. distributed — see the paragraph after the kernels line below.
 34. cli       — python -m ntt_aie_tpu_torch info in a subprocess; through
                 cli.main: verify on p = 2013265921 at log-n 12, on Kyber
                 and Dilithium at log-n 8 (each with --native, the
                 standalone nttverify gate), on Goldilocks and --parity,
                 every label [PASS]; bench for fwd, inv and polymul at
                 n = 2^20 over p = 469762049 (B = 256) and Goldilocks
                 (B = 64), each JSON line "verified": true on CUDA events,
                 fwd with --calibrate (the measured HBM and butterfly
                 rates);
 35. trace, trace_busy — the CLI's trace at n = 2^20 for fwd, inv,
                 polymul and fwd with --no-wmat-fold and --wmat-factored:
                 method "profiler", the derived rows naming the column
                 passes in program order (cp1 then cp2, icp2 then icp1;
                 a capture that misses a pass taken again, up to
                 TRACE_ATTEMPTS times, its attempts in the line),
                 each pass's traced time beside CUDA events around a chain
                 of it (host-bound at B = 1) and behind a sleep (the
                 device's time alone); then capture_trace over a chain of
                 5 fwd_mat at B = 256, one B = 1 fwd and a chain of 20:
                 the traced window, the device time and the busy share;
 36. sweep     — run_sweep at log-n 12-20, B = 1 and 64, its CSVs under
                 build/chip_smoke/sweep;
 37. scaling   — run_scaling at D = 1, 2 with gloo (D = 2: two ranks that
                 share the card, never a multi-chip figure) and the NCCL
                 request (D = 2 skipped with a printed line on one card);
 38. stream    — stream_transform over 8 host batches of fwd_mat at
                 n = 2^20, B = 16, each output equal to a direct call; its
                 time beside a serial pageable loop and the same pipeline
                 at prefetch 1, in turns.
Each of phases 34-38 zeroes the column kernels' counts just before its
driven calls, reads them just after and fails if none launched; the
colpass and gl_colpass rows carry them as "entry_point_launches".
 39. examples  — the worked examples (ntt_aie_tpu_torch/examples), each
                 run() on the card with its own checks (EXAMPLE_RUNS):
                 rlwe at log-n 10 and 16 (the fused kernel's negacyclic
                 product on the flat split), bigint at 4,096 and 2^20
                 bits (RNS: column passes and the CRT combine), matform at
                 n = 2^12, B = 4 and at the main path's n = 2^20, B = 256
                 (the cached-spectrum loop equal to polymul_mat on every
                 row, row 0 and 8 random rows on the native oracle, the
                 loop and polymul_mat timed in turns, us per
                 NTT-product), pqc at B = 64 and 1,024 (ring_layers.cu,
                 EXAMPLE_RING_LAUNCHES a run),
                 distributed at its default world (one NCCL rank a card)
                 and at four gloo ranks that share the card (the
                 hierarchical branch; not a multi-chip figure); one line
                 an example with its sizes, seconds and kernel launches
                 (counted from 0 just before the run, the distributed
                 demo's in its ranks), failing when a check fails or a
                 listed kernel did not launch. The colpass,
                 fused_fourstep, crt and ring_layers rows carry them as
                 "examples_launches".

Then one line {"kernels": [...]}: per kernel its time at the main path's
shape ("ms", per launch), launches, the plain version's time, and its
bound — the larger of the bytes it must move over the card's 3.35 TB/s and
its butterflies over the measured ideal rate of its arithmetic (phase 15;
its measured HBM rate is reported there, not used as a bound); library_ms
is null (no single PyTorch call computes an NTT mod p). The colpass and
gl_colpass rows also carry their kFuse, registers and blocks per SM (cp1's
kernel), the fused row its inv_mat time, its kFuse and blocks per SM, the
nested row its time, registers and blocks per SM at each fuse. Phases
17-19 add a colpass[<reduction>] and a fused_fourstep[<reduction>] row
for each of montgomery, harvey and barrett, bound by that reduction's
probe rate. Phases 24-26 add a colpass[<pass>] row for each 'pre'/'post'
instantiation at n = 2^20, B = 256 (harvey4; each timed alone, its
launches its own path's) and the crt row (the combine at n = 2^20,
B = 16, three primes; bound by its bytes). Phases 27-28 add a
colpass[factored:<pass>] row for each factored or rank-1 instantiation
(harvey4, n = 2^20, B = 256) and a gl_colpass[<arm>:<pass>] row for each
new Goldilocks one (B = 64), their bytes with their operand tables.
Phase 29 adds a ring_layers[<scheme>_<ntt|intt>] row for each of the four
instantiations at B = 8,192: "ms" the kernel alone, "wrapper_ms" the
pipeline's call, its launches by call, its bytes the input and output
once, its butterflies 128 a layer a polynomial over the barrett (ML-KEM)
or montgomery (ML-DSA) probe rate. Phases 31-33 drive the distributed
four-step plan (parallel/fourstep.py): phase 31 holds every column pass
of its two arms (rank 0 of D = 4, C = 2, at the 4096 x 4096 split; the
Goldilocks passes there on their tall route, above GL_LAUNCH_ROWS)
against its plain version and times the instantiations it added; phase 32
runs the path on four ranks that share the card (run_spmd, gloo's
all_to_all_single on CUDA tensors): the factored and full-matrix arms at
n = 2^24 with two chunks (fwd, inv, polymul, negacyclic_polymul), a 2 x 2
dp mesh at n = 2^22, B = 4, a 2 x 2 hierarchical mesh and the pairwise
mode at n = 2^24, and Goldilocks at n = 2^20 (both arms, negacyclic), each
gathered output equal to the single-device plan's and fwd to the native
oracle, then the "distributed" line (backend, world, mesh, shapes, ms per
call; not a multi-chip figure); phase 33 runs one rank on NCCL at
n = 2^20. They add a colpass[dist:...] row (1d) or gl_colpass[dist:...]
row (3d) for each instantiation the distributed plan added: ms per launch
at B = 8, launches summed over phase 32's ranks, launches a transform,
bytes with the operand tables. Each row's launches are its own path's;
the flat phases' (phases 20 and 22's driven calls) are under
"flat_launches". Phase 40 (tall, tall_done) runs the column passes
above one launch's rows (32-bit: above ops/colpass.py LAUNCH_ROWS =
4,096, so BabyBear's 8,192-row cp1 and icp1 too; Goldilocks: above
GL_LAUNCH_ROWS = 2,048), each as its two launches (ops/colpass.py
tall_phases), on BabyBear at n = 2^27 and Goldilocks at n = 2^27
(8192 x 16384), at 2^24 (4096 x 4096) and at 2^28 on the factored arm
(16384 x 16384, dropped if its set-up passes 60 s), B = 1, through
make_batched(1)'s fwd_mat, inv_mat and polymul_mat: launches by
instantiation counted from 0 a call, every tall launch on the path's own
input equal to its plain version raw and the pair to the whole pass's,
fwd_mat and polymul_mat equal to the plain passes' chain on the card,
BabyBear's fwd_mat and Goldilocks 2^24's fwd_mat and polymul_mat on the
native oracle (row 0, in worker threads), the round trip, µs a call and
ms a launch, every pass's kernel_info; it adds a
colpass[tall:<case>:<pass><A|B>] row (PERF.md 1t) or a gl_colpass[...]
row (3t) for each launch, its bound its own (the launch reads and writes
the array once), the pass's bytes and butterflies beside it. Phase 41
(splits, splits_done) runs every split the JAX package computes that
raised on the card before: the split (1, n) (a column pass of one row, no
stage: colpass_empty_kernel) at n = 2^20 over p = 469762049 on the fold
and fused plans and over Goldilocks at n = 2^16; the fused plan's step
lists (sides above one launch's rows, sides of one row) at n = 2^17,
8 x 16384 and 16384 x 8, B = 2, on every callable, at (1, 2^20), and
BabyBear n = 2^27 at 8192 x 16384 (aA, aB, bA, bB) and at (1, 2^27) (a
one-row step, then side b's four split-phase steps); and tall phases above
one launch's rows (two launches split by stage group) on Goldilocks
n = 2^28 at (2, 2^27) on the factored arm (its 2-row cp1 and icp1 on
the short kernel) and BabyBear (1, 2^27); and Goldilocks n = 2^20 at
(8, 2^17) (the short kernel's 8-row cp1 and icp1):
launches counted from 0 a call, every column-pass launch on the path's
own input equal to its plain version raw (column slices) and the
launches to the whole pass's, every fused transform to
fused_fourstep_plain and every step of a step list (the list's prefix up
to it, fused_fourstep.step_prefix, launched on the card at the whole
list's kernel, grid and shared memory) to its plain
versions' chain (fused_step_plain), raw, every callable to the plain
passes' chain, fwd's rows on the native oracle (in worker threads beside
the card's work), the round trips; ms a launch, a fused call or a step,
fwd_mat's µs as one call (the call the oracle gates, at (1, 2^20) and
(1, 2^27) too), and each fused plan's fwd_mat in turns with the fold
plan's. It adds a
colpass[split:<case>:<pass><launch>] row (PERF.md 1s, 1t),
gl_colpass[...] row (3s, 3t, 3q: a short launch) or
fused_fourstep[split:<case>:<ff|fi|nf|ni>] row (2t) for each, a column
launch's rows, tile columns, registers and blocks an SM beside it. Phase 42
(pointwise) holds the 32-bit pointwise product (csrc/pointwise.cu,
ops.pointwise.mul32: every 32-bit ring product's step between the
transforms) against its plain version raw for every 32-bit prime of the
port and 2^31 - 1: random uint32 values and the edges, an odd size (one
value a thread), (4, 2^20) (16-byte vectors), b broadcast over a batch
(a power-of-two and another row length) and an unaligned view; then times
it at n = 2^20, B = 256 over the primes of harvey4, harvey and
montgomery and at n = 256, B = 16,384 over Kyber's, the plain version
beside it and its byte bound (12 bytes a value). Its pointwise32 row's
launches are the main paths' (the products of phases 4, 10, 18 and 26;
phase 20's in "flat_launches"), its time and bound those of harvey4's
prime at B = 256. Last, the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints no result and exits 2.
"""

import argparse
import json
import subprocess
import sys
import time

# The (n1, n2) splits the 32-bit column kernel is held against its plain
# version at: nested at TL 8, 16 and 4 (asymmetric both ways), plain at
# TL 32.
COLPASS_KERNEL_SHAPES = ((1024, 1024), (128, 512), (2048, 512), (512, 2048),
                         (32, 64), (64, 32))
# The Goldilocks path: n = 2^GL_LOG_N at batch GL_BATCH (the 1024 x 1024
# split), and the shapes the kernel is held against its plain version at.
GL_LOG_N = 20
GL_BATCH = 64
GL_KERNEL_SHAPES = ((1024, 1024), (128, 512), (2048, 256))
# The (n1, n2) splits the fused kernel is held against its plain version
# at: nested both sides, nested asymmetric both ways, plain both ways.
FUSED_KERNEL_SHAPES = ((1024, 1024), (512, 2048), (2048, 512), (32, 64),
                       (64, 32))
NESTED_BATCH, NESTED_CHAIN = 64, 8
# (batch, n1, n2, R, fuse) the nested kernel is held against its plain
# version at: the bench's shape at every fuse, the check's, smaller
# batches at shapes where the stage groups do not divide the phases, and
# at every fuse the networks with an empty phase: phase 0 (R = 1; n1 = 2,
# whose default R is 1) or phase 1 (R = n1, at TL 16: the clamped shift)
NESTED_KERNEL_CASES = (
    tuple((NESTED_BATCH, 1024, 1024, None, f) for f in range(1, 6))
    + ((1, 1024, 256, None, 3),)
    + tuple((4, 1024, 1024, None, f) for f in range(1, 6))
    + ((4, 2048, 512, None, 3), (4, 256, 512, 8, 3), (4, 64, 512, None, 3))
    + tuple((4, n1, n2, R, f) for n1, n2, R in
            ((256, 512, 1), (256, 16, 256), (2, 512, None))
            for f in range(1, 6)))
SPEC_HBM_GBPS = 3350.0  # H100 SXM data sheet, GB/s
# The plans of phases 17-19: (reduction, field name, log_n, rows_log2,
# batch), the fields where 'auto' picks each; Kyber on its pinned 16 x 16
# split at the batch of an ML-KEM endpoint batching handshakes
RED_PLANS = (("montgomery", "p2013265921", 20, 10, 256),
             ("harvey", "p998244353", 20, 10, 256),
             ("barrett", "kyber", 8, 4, 16384))
# The flat phases F1-F5 (phase 20): (phase, field name, log_n, batch,
# log_n of the negacyclic product or None), each on the flat split
# (NTTConfig's default up to n = 2^16, 2^14 for Goldilocks) through the
# fold plan and, for the 32-bit fields, the fused plan: the largest
# 32-bit flat ring (RNS/FHE products over p = 469762049), ML-KEM (Kyber,
# negacyclic at n = 128, its largest) and ML-DSA (Dilithium) batches, the
# other two RNS primes, and the largest Goldilocks flat size (STARK trace
# columns)
FLAT_PLANS = (("F1", "p469762049", 16, 256, 16),
              ("F2", "kyber", 8, 16384, 7),
              ("F3", "dilithium", 8, 16384, 8),
              ("F4", "p2013265921", 16, 64, None),
              ("F4", "p998244353", 16, 64, None),
              ("F5", "goldilocks", 14, 256, 14))
# The rows the plain flat stage loops are held and timed at
FLAT_PLAIN_BATCH = 16
# Route (a) of the flat forward (phase 21: the column pass over (1, n, B)
# with the batch as columns), timed beside the plans' route (b):
# (field name, log_n, batch)
FLAT_ROUTE_A = (("kyber", 8, 16384), ("p469762049", 12, 4096))
# The (n1, n2) splits phase 17 holds each reduction's kernels at
RED_KERNEL_SHAPES = {"montgomery": ((1024, 1024), (32, 64)),
                     "harvey": ((1024, 1024), (32, 64)),
                     "barrett": ((16, 16), (16, 8))}
# The column kernel's instantiations with 'pre' and 'post' operands, by
# the plan passes that run them (phase 23): (fold_passes keyword
# arguments, pass)
PREPOST_PASSES = (({"negacyclic": True}, "ncp1"),
                  ({"negacyclic": True}, "nicp1"),
                  ({"wmat_fold": False}, "cp2"),
                  ({"wmat_fold": False}, "icp1"),
                  ({"wmat_fold": False, "negacyclic": True}, "ncp1"),
                  ({"wmat_fold": False, "negacyclic": True}, "nicp1"))
# (reduction, field name, (n1, n2) splits) of phase 23: the main path's
# split, an asymmetric nested one and a plain one; Kyber at its largest
# negacyclic size
PREPOST_KERNEL_SHAPES = (
    ("harvey4", "p469762049", ((1024, 1024), (512, 2048), (32, 64))),
    ("montgomery", "p2013265921", ((1024, 1024), (32, 64))),
    ("harvey", "p998244353", ((1024, 1024), (32, 64))),
    ("barrett", "kyber", ((16, 8),)))
# The column kernels' factored ('wfac') and rank-1 instantiations and the
# Goldilocks kernel's 'pre' matrix (phase 23), by the plan passes that run
# them: (fold_passes / gl_fold_passes keyword arguments, pass)
WFAC_PASSES = (({"wmat_factored": True}, "cp2"),
               ({"wmat_factored": True}, "icp2"),
               ({"wmat_factored": True, "negacyclic": True}, "ncp1"),
               ({"wmat_factored": True, "negacyclic": True}, "nicp1"))
GL_ARM_PASSES = (({"wmat_fold": False}, "cp2"), ({"wmat_fold": False}, "icp1"),
                 ({"wmat_factored": True}, "cp2"),
                 ({"wmat_factored": True}, "icp2"))
# (reduction, field name, (n1, n2) splits) of phase 23's factored passes:
# the main path's split, 128 x 512 and the 8,192-row column (64 columns:
# the split (8192, 64) for the passes over n1 rows, (64, 8192) for those
# over n2); Kyber at its largest negacyclic size. Goldilocks: 1024 x 1024,
# 2048 x 256 and the 8,192-row column.
WFAC_KERNEL_SHAPES = tuple(
    (kind, name, ((1024, 1024), (128, 512), (8192, 64), (64, 8192)))
    for kind, name in (("harvey4", "p469762049"),
                       ("montgomery", "p2013265921"),
                       ("harvey", "p998244353"))) + (
    ("barrett", "kyber", ((16, 8),)),)
GL_ARM_KERNEL_SHAPES = ((1024, 1024), (2048, 256), (8192, 64), (64, 8192))
# The other plans of phase 27 held equal to their fold plan: (reduction,
# field name, log_n, rows_log2, batch, negacyclic); Kyber at n = 256 on its
# pinned 16 x 16 split (no negacyclic product there: n = 128 is its
# largest)
FAC_CHECKS = (("montgomery", "p2013265921", 20, 10, 256, True),
              ("barrett", "kyber", 8, 4, 16384, False))
# The negacyclic fold plans of phase 24: (field name, log_n, rows_log2,
# batch): the main path's size over p = 469762049, the other two default
# RNS primes at B = 64, and Kyber at n = 128 (its largest negacyclic size)
# on a pinned split at the batch of an ML-KEM endpoint
NEGA_PLANS = (("p469762049", 20, None, 256), ("p2013265921", 20, None, 64),
              ("p998244353", 20, None, 64), ("kyber", 7, 3, 16384))
# RNSPolymul on the card (phase 26): (log_n, negacyclic, batch), and the
# log_n held against the schoolbook integer product
RNS_CASES = ((20, False, 16), (20, True, 16), (16, True, 64))
RNS_EXACT_LOG_N = 10
# n = 2 on the flat split (phase 20): the fields and the batch
FLAT_N2 = ("p469762049", "goldilocks")
FLAT_N2_BATCH = 4096
# The PQC rings (phase 29): (scheme, k, l) of the serving steps (ML-KEM-768:
# A 3 x 3; ML-DSA-65: A 6 x 5), at the reference's sizes
# (scripts/regen_pqc_numbers.py:29-71): the transforms and the ring
# product at PQC_BATCH, the serving steps at PQC_SERVING_BATCH; the plain
# version also timed at PQC_PLAIN_BATCH
PQC_SERVING = (("kyber", 3, 3), ("dilithium", 6, 5))
PQC_BATCH = 8192
PQC_SERVING_BATCH = 1024
PQC_PLAIN_BATCH = 64
PQC_ODD_BATCH = 13  # leaves a block of 8 rows part-filled
PQC_BATCHED_ROWS = 64  # serving_step with a matrix a row, on the main path
# A cold reading cycles over input copies that move at least this many
# bytes between two uses of one copy (4x the H100's 50 MB L2)
PQC_COLD_BYTES = 200_000_000
# The fused ring products' instantiations (ops.ring_layers.ring_product):
# (mode, matrix form), None for two vectors, "shared" one (k, l, 256)
# matrix for the whole batch, "batched" a matrix a batch row
PQC_PRODUCTS = (("product", None), ("pointwise", None),
                ("matvec", "shared"), ("matvec", "batched"),
                ("serve", "shared"), ("serve", "batched"),
                ("serve_fresh", "batched"))
# The launches of each pipeline call on the main path, by instantiation
# (the scheme's name before each key)
PQC_LAUNCHES = {"ntt": {"ntt": 1}, "intt": {"intt": 1},
                "polymul": {"product": 1}, "pointwise": {"pointwise": 1},
                "ntt_A": {"ntt": 1}, "matvec": {"matvec": 1},
                "make_serving_step": {"serve": 1},
                "serving_step": {"ntt": 1, "serve": 1},
                "matvec[batched A]": {"matvec_batched": 1},
                "make_serving_step[batched A]": {"serve_batched": 1},
                "serving_step[batched A]": {"serve_fresh": 1}}
# What each fused instantiation replaces: the reference's callable, which
# its jit_pipeline (ntt_aie_tpu/ring_layers.py:82) compiles under XLA
PQC_REPLACES = {
    name: {"product": f"ntt_aie_tpu/{name}.py:{lines[0]} (XLA, a helper "
                      "kernel)",
           "pointwise": f"ntt_aie_tpu/{name}.py:{lines[1]} (XLA, a helper "
                        "kernel)",
           "matvec": f"ntt_aie_tpu/{name}.py:{lines[2]} (XLA, a helper "
                     "kernel)",
           "serve": "ntt_aie_tpu/ring_layers.py:103 (XLA, a helper kernel)",
           "serve_fresh": "ntt_aie_tpu/ring_layers.py:100 (XLA, a helper "
                          "kernel)"}
    for name, lines in (("kyber", (84, 68, 101)),
                        ("dilithium", (70, 61, 87)))}
# Phase 42, the 32-bit pointwise product: the moduli it is held at (every
# 32-bit field of the port, and 2^31 - 1, the largest montgomery takes),
# and its timed cases, (field name, n, batch): the main path's n = 2^20 at
# B = 256 under harvey4, harvey and montgomery, and Kyber's n = 256 at
# B = 16,384 (barrett's phase 18 batch)
PW_MODULI = ("kyber", "dilithium", "p469762049", "p998244353",
             "p2013265921", (1 << 31) - 1)
PW_TIMED = (("p469762049", 1 << 20, 256), ("p998244353", 1 << 20, 256),
            ("p2013265921", 1 << 20, 256), ("kyber", 256, 16384))
# Reference parity (phase 30): (field name, log_n, ordering): the paper's
# configuration (Kyber, n = 2048, the device's 16-block layout) and
# harvey4 at n = 2^20
PARITY_CASES = (("kyber", 11, "reference"), ("p469762049", 20, "bitrev"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> int:
    emit({"phase": phase, "ok": False, "error": msg})
    return 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2

    import numpy as np

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle, reference
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import nested_colpass as N
    from ntt_aie_tpu_torch.ops import pointwise as PW
    from ntt_aie_tpu_torch.plan import fold_passes
    from ntt_aie_tpu_torch.profiling import roofline as RL
    from ntt_aie_tpu_torch.utils.timing import time_device

    field = T.P_469762049
    p = field.p
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    # 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card or "nvidia-smi: not available", flush=True)
    emit({"phase": "env", "ok": True, "card": card,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # 2. build: one nvcc per source, all started at once; phases 3-4 run
    # on the harvey4 column library while the others compile, and every
    # build is waited for before phase 5's timings
    t0 = time.perf_counter()
    builds = C.start_builds()
    build_end = {}  # each library's seconds from the start to its end
    for key, fut in builds.items():
        fut.add_done_callback(lambda _, key=key: build_end.setdefault(
            key, time.perf_counter() - t0))
    builds["colpass[harvey4]"].result()

    # 3. kernel against plain, on the card
    cases = [(name, cp, (B,) + ((n1, n2) if name in ("cp1", "icp1")
                                else (n2, n1)))
             for n1, n2 in COLPASS_KERNEL_SHAPES
             for name, cp in fold_passes(field, n1, n2, device=dev).items()
             for B in (1, 4)]
    cases += [(direction, C.make_colpass(field, 8192, direction=direction,
                                         inverse_tw=direction == "dit",
                                         device=dev), (1, 8192, 64))
              for direction in ("dif", "dit")]
    max_err = 0
    for name, cp, shape in cases:
        x = torch.randint(0, 4 * p, shape, dtype=torch.int64, device=dev,
                          generator=gen).to(torch.int32)
        got = C.colpass(x, cp)
        torch.cuda.synchronize()
        want = C.colpass_plain(x, cp)
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        emit({"phase": "kernel", "pass": name, "shape": list(shape),
              "network": "nested" if cp.wmid is not None else "plain",
              "tile_cols": C.tile_cols(shape[1], shape[2]),
              "equal": bool(torch.equal(got, want)), "max_abs_err": err})
        if err or not torch.equal(got, want):
            return fail("kernel", f"{name} {shape} differs from its plain "
                        "version")

    # 4. slice: the main path at n = 2^20, B = 256
    cfg = T.NTTConfig(field=field, log_n=20)
    n, (n1, n2) = cfg.n, cfg.split
    B = 256
    plan = T.build_plan(cfg, device=dev)
    bat = plan.make_batched(B)
    x = torch.randint(0, p, (B, n1, n2), dtype=torch.int32, device=dev,
                      generator=gen)
    launches = {}
    pw_launches = {}
    C.colpass.launches = PW.mul32.launches = 0
    y = bat["fwd_mat"](x)
    torch.cuda.synchronize()
    launches["fwd_mat"] = C.colpass.launches
    pw_launches["fwd_mat"] = PW.mul32.launches

    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
    got = y.reshape(B, n)[torch.from_numpy(gate_rows).to(dev)].cpu().numpy()
    rows_in = x.reshape(B, n)[torch.from_numpy(gate_rows).to(dev)].cpu()
    rows_in = rows_in.numpy().astype(np.uint64)
    try:
        want = native_oracle.ntt_dif_batch(
            rows_in, field.root_of_unity(n), p)[:, tw.bit_reverse_indices(n)]
        oracle = "native"
    except (native_oracle.NativeOracleUnavailable, OSError):
        want = np.stack([reference.ntt_forward(r, field) for r in rows_in])
        oracle = "numpy"
    gate_ok = np.array_equal(
        got[:, plan.spectral_to_natural].astype(np.uint64),
        want.astype(np.uint64))

    C.colpass.launches = PW.mul32.launches = 0
    back = bat["inv_mat"](y)
    torch.cuda.synchronize()
    launches["inv_mat"] = C.colpass.launches
    pw_launches["inv_mat"] = PW.mul32.launches
    roundtrip_ok = bool(torch.equal(back, x))
    del back, y

    bat2 = plan.make_batched(2)
    a, b = x[:2], x[2:4]
    C.colpass.launches = PW.mul32.launches = 0
    c = bat2["polymul_mat"](a, b)
    torch.cuda.synchronize()
    launches["polymul_mat"] = C.colpass.launches
    pw_launches["polymul_mat"] = PW.mul32.launches
    want_c = reference.cyclic_polymul(a[0].reshape(n).cpu().numpy(),
                                      b[0].reshape(n).cpu().numpy(), field)
    poly_ok = np.array_equal(c[0].reshape(n).cpu().numpy().astype(np.int64),
                             want_c)
    counts_ok = (launches == {"fwd_mat": 2, "inv_mat": 2, "polymul_mat": 6}
                 and pw_launches == {"fwd_mat": 0, "inv_mat": 0,
                                     "polymul_mat": 1})
    emit({"phase": "slice", "n": n, "split": [n1, n2], "batch": B,
          "reduction": plan.reduction, "oracle": oracle,
          "gate_rows": gate_rows.tolist(), "gate_ok": bool(gate_ok),
          "roundtrip_ok": roundtrip_ok, "polymul_ok": bool(poly_ok),
          "launches": launches, "pointwise32_launches": pw_launches,
          "launches_ok": counts_ok,
          "ok": gate_ok and roundtrip_ok and poly_ok and counts_ok})
    if not (gate_ok and roundtrip_ok and poly_ok and counts_ok):
        return fail("slice", "the main path disagrees with its oracles")

    libs = {key: fut.result() for key, fut in builds.items()}
    build_s = time.perf_counter() - t0
    C._library()
    G._library()
    F._library()
    N._library()
    RL._library()
    PW._library()
    from ntt_aie_tpu_torch import dilithium, kyber
    from ntt_aie_tpu_torch.ops import ring_layers as LR

    for scheme in (kyber.SCHEME, dilithium.SCHEME):
        LR.check_constants(scheme)
    emit({"phase": "build", "ok": True, "seconds": build_s,
          "library_seconds": dict(sorted(build_end.items(),
                                         key=lambda kv: kv[1])),
          "libraries": sorted(p.name for p in libs.values()),
          "method": "every nvcc started at once at phase 2; seconds to "
                    "the last build's end, beside phases 3-4"})

    # 5. time: kernel path at B = 256, plain path at B = 256 or less
    cp1, cp2 = plan.passes["cp1"], plan.passes["cp2"]
    k_fwd = time_device(bat["fwd_mat"], x)["us_per_iter"]
    k_cp1 = time_device(cp1, x)["us_per_iter"]
    k_cp2 = time_device(cp2, x)["us_per_iter"]
    info = {name: C.kernel_info(cp, x.shape[2])
            for name, cp in (("cp1", cp1), ("cp2", cp2))}

    def plain_fwd(v):
        return C.colpass_plain(C.colpass_plain(v, cp1), cp2)

    pb = B
    while True:
        try:
            xp = x[:pb]
            p_fwd = time_device(plain_fwd, xp)["us_per_iter"]
            p_cp1 = time_device(lambda v: C.colpass_plain(v, cp1),
                                xp)["us_per_iter"]
            p_cp2 = time_device(lambda v: C.colpass_plain(v, cp2),
                                xp)["us_per_iter"]
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            if pb == 1:
                raise
            pb //= 2
    timing = {
        "phase": "time", "card": card, "batch": B, "plain_batch": pb,
        "kernel_us_per_ntt": k_fwd / B,
        "plain_us_per_ntt": p_fwd / pb,
        "kernel_cp1_us_per_pass": k_cp1 / B,
        "kernel_cp2_us_per_pass": k_cp2 / B,
        "plain_cp1_us_per_pass": p_cp1 / pb,
        "plain_cp2_us_per_pass": p_cp2 / pb,
        "kernel_ntt_per_s": B / (k_fwd * 1e-6),
        "kernel_info": info,
        "method": "CUDA events, 5 repeats of a dependent chain of 10, "
                  "trimmed mean; us per NTT = us per call / batch",
    }
    emit(timing)

    del x, bat, plan
    torch.cuda.empty_cache()

    gl_rows = goldilocks_phases(args, dev, card, rng)
    if gl_rows is None:
        return 1
    torch.cuda.empty_cache()
    fused_row = fused_phases(args, dev, card, rng)
    if fused_row is None:
        return 1
    torch.cuda.empty_cache()
    nested_rows = nested_phases(args, dev, card)
    if nested_rows is None:
        return 1
    torch.cuda.empty_cache()
    roof = roofline_phase(dev, card)
    if roof is None:
        return 1
    torch.cuda.empty_cache()
    if not batch_split_phase(args, dev):
        return 1
    torch.cuda.empty_cache()
    red_rows = reduction_phases(args, dev, card, rng)
    if red_rows is None:
        return 1
    torch.cuda.empty_cache()
    flat_launches = flat_phases(args, dev, card, rng)
    if flat_launches is None:
        return 1
    torch.cuda.empty_cache()
    prepost_errs = prepost_kernel_phase(args, dev)
    if prepost_errs is None:
        return 1
    torch.cuda.empty_cache()
    got = nega_fold_phase(args, dev, card, rng)
    if got is None:
        return 1
    nega_launches, nega_time = got
    torch.cuda.empty_cache()
    got = wmat_entry_phase(args, dev, card)
    if got is None:
        return 1
    entry_launches, entry_time = got
    torch.cuda.empty_cache()
    crt_row = rns_phase(args, dev, card, rng)
    if crt_row is None:
        return 1
    torch.cuda.empty_cache()
    got = wfac_phase(args, dev, card, rng)
    if got is None:
        return 1
    wfac_launches, wfac_time = got
    torch.cuda.empty_cache()
    got = gl_arms_phase(args, dev, card, rng)
    if got is None:
        return 1
    gl_arm_launches, gl_arm_time = got
    torch.cuda.empty_cache()
    pqc_rows = pqc_phases(args, dev, card, rng)
    if pqc_rows is None:
        return 1
    torch.cuda.empty_cache()
    if reference_parity_phase(args, dev, card, rng) is None:
        return 1
    torch.cuda.empty_cache()
    dist_rows = distributed_phases(args, dev, card, rng)
    if dist_rows is None:
        return 1
    torch.cuda.empty_cache()
    entry_point_launches = entry_point_phases(args, dev, card, rng)
    if entry_point_launches is None:
        return 1
    torch.cuda.empty_cache()
    example_launches = examples_phase(dev, card, rng)
    if example_launches is None:
        return 1
    torch.cuda.empty_cache()
    tall_rows = tall_phase(dev, card, gen)
    if tall_rows is None:
        return 1
    torch.cuda.empty_cache()
    split_rows = split_phase(dev, card, gen)
    if split_rows is None:
        return 1
    torch.cuda.empty_cache()
    pw_row = pointwise_phase(dev, card, gen)
    if pw_row is None:
        return 1
    # the product's launches on the main paths: the slice's, the fused
    # slice's, the reductions' slices and the RNS products'
    pw_row["launches"] = (sum(pw_launches.values())
                          + fused_row.pop("pointwise32_launches")
                          + sum(r.pop("pointwise32_launches", 0)
                                for r in red_rows)
                          + crt_row["pointwise32_launches"])
    # the probe's time is one launch of phase 15's harvey4 r = 64 reading
    nested_rows[1].update(
        ms=roof["probe"]["harvey4"]["us_per_pass"] / 1e3,
        max_abs_err=max(v["max_abs_err"] for v in roof["probe"].values()))

    # ms per launch in the fwd_mat chain (one call is 2 launches), at the
    # batch each path was timed at; bytes and butterflies of one launch
    rows = [{
        "name": "colpass", "route": "cuda",
        "source": "ntt_aie_tpu_torch/csrc/colpass.cu",
        "replaces": "ntt_aie_tpu/ops/pallas_ntt.py:298",
        "launches": sum(launches.values()), "max_abs_err": max_err,
        "ms": k_fwd / 2 / 1e3, "plain_ms": p_fwd / 2 / 1e3,
        "batch": B, "plain_batch": pb,
        "bytes": (4 * B * n * 4 + 2 * n * 4) / 2,
        "butterflies": B * n // 2 * 10, "arithmetic": "harvey4",
        "kfuse": info["cp1"]["kfuse"], "registers": info["cp1"]["registers"],
        "blocks_per_sm": info["cp1"]["blocks_per_sm"],
    }] + gl_rows + [fused_row] + nested_rows + red_rows
    rows += _prepost_rows(prepost_errs, nega_launches, nega_time,
                          entry_launches, entry_time, B, n)
    rows += _factored_rows(prepost_errs, wfac_launches, wfac_time,
                           gl_arm_launches, gl_arm_time)
    rows.append({
        "name": "crt", "route": "cuda",
        "source": "ntt_aie_tpu_torch/csrc/crt.cu",
        "replaces": "ntt_aie_tpu/ops/crt.py:89 (XLA, a helper kernel)",
        "launches": crt_row["launches"], "max_abs_err": crt_row["max_abs_err"],
        "ms": crt_row["ms"], "plain_ms": crt_row["plain_ms"],
        "batch": crt_row["batch"], "plain_batch": crt_row["batch"],
        "bytes": crt_row["bytes"], "butterflies": 0,
        "coefficients": crt_row["count"], "primes": crt_row["k"],
        "nwords": crt_row["nwords"]})
    rows += pqc_rows
    rows += dist_rows
    rows += tall_rows
    rows += split_rows
    rows.append(pw_row)
    # the launches of the entry points of phases 34-38, by kernel
    for row in rows:
        if row["name"] in entry_point_launches:
            row["entry_point_launches"] = entry_point_launches[row["name"]]
    # the launches of the worked examples of phase 39, by kernel
    for row in rows:
        if row["name"] in example_launches:
            row["examples_launches"] = example_launches[row["name"]]
    # each row's launches are its own path's; the flat phases' apart
    for row in rows:
        row["flat_launches"] = flat_launches.get(row["name"], 0)
    emit({"kernels": [_with_bound(row, roof) for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _prepost_rows(errs, nega_launches, nega_time, entry_launches,
                  entry_time, B, n):
    """The kernels-line rows of the column kernel's 'pre'/'post'
    instantiations at n = 2^20, B = 256 over p = 469762049 (harvey4): each
    timed alone (phases 24 and 25), its launches from its own path's run
    (the fold plan's negacyclic product; the entry arm's callables), its
    bytes the input and output once and its operand tables ((w, w') pairs,
    8 bytes a value), its butterflies the column network's."""
    specs = (("ncp1", "dif+pre+post_t+T", nega_time, nega_launches, 2),
             ("nicp1", "dit+post", nega_time, nega_launches, 1),
             ("entry:cp2", "dif+pre", entry_time, entry_launches, 1),
             ("entry:icp1", "dit+pre", entry_time, entry_launches, 1),
             ("entry:ncp1", "dif+pre+T", entry_time, entry_launches, 1),
             ("entry:nicp1", "dit+pre+post", entry_time, entry_launches, 2))
    rows = []
    for name, variant, line, launches, tables in specs:
        key = name.split(":")[-1]
        info = line["kernel_info"][key]
        rows.append({
            "name": f"colpass[{name}]", "route": "cuda",
            "source": "ntt_aie_tpu_torch/csrc/colpass.cu",
            "replaces": "ntt_aie_tpu/ops/pallas_ntt.py:298",
            "variant": variant, "launches": launches.get(variant, 0),
            "max_abs_err": errs.get(variant, 0),
            "ms": line["pass_us_per_call"][key] / 1e3,
            "plain_ms": line["plain_us_per_call"][key] / 1e3,
            "batch": B, "plain_batch": line["plain_batch"],
            "bytes": 2 * B * n * 4 + tables * n * 8,
            "butterflies": B * n // 2 * 10, "arithmetic": "harvey4",
            "registers": info["registers"],
            "blocks_per_sm": info["blocks_per_sm"]})
    return rows


def _factored_rows(errs, launches, line, gl_launches, gl_line):
    """The kernels-line rows of the column kernels' factored and rank-1
    instantiations (PERF.md row 1f: harvey4, n = 2^20, B = 256) and of
    the Goldilocks kernel's 'pre' matrix and factored ones (row 3p:
    n = 2^20, B = 64), one row an instantiation, each timed alone (phases 27 and 28), its launches from its
    own phase's driven calls, its bytes the input and output once and its
    operand tables once (pairs of 8 bytes: the factored tables (n2/S + S)
    x n1, the rank-1 vectors n1 + n2, the Goldilocks matrix n; S = 32 at
    1024 x 1024), its butterflies the column network's."""
    n1 = n2 = 1024
    n, s = n1 * n2, 32
    fac_bytes, rank1_bytes = (n2 // s + s) * n1 * 8, (n1 + n2) * 8
    rows = []
    for name, variant, tables in (
            ("cp2", "dif+wfac_pre", fac_bytes),
            ("icp2", "dit+wfac_post+T", fac_bytes),
            ("ncp1", "dif+rank1_pre+T", rank1_bytes),
            ("nicp1", "dit+rank1_post", rank1_bytes)):
        info = line["kernel_info"][name]
        B = line["batch"]
        rows.append({
            "name": f"colpass[factored:{name}]", "perf_row": "1f",
            "route": "cuda",
            "source": "ntt_aie_tpu_torch/csrc/colpass.cu",
            "replaces": "ntt_aie_tpu/ops/pallas_ntt.py:298",
            "variant": variant, "launches": launches.get(variant, 0),
            "max_abs_err": errs.get(variant, 0),
            "ms": line["pass_us_per_call"][name] / 1e3,
            "plain_ms": line["plain_us_per_call"][name] / 1e3,
            "batch": B, "plain_batch": line["plain_batch"],
            "bytes": 2 * B * n * 4 + tables, "table_bytes": tables,
            "butterflies": B * n // 2 * 10, "arithmetic": "harvey4",
            "registers": info["registers"],
            "blocks_per_sm": info["blocks_per_sm"]})
    for key, variant, tables in (
            ("entry:cp2", "dif+pre", n * 8),
            ("entry:icp1", "dit+pre", n * 8),
            ("factored:cp2", "dif+wfac_pre", fac_bytes),
            ("factored:icp2", "dit+wfac_post+T", fac_bytes)):
        info = gl_line["kernel_info"][key]
        B = gl_line["batch"]
        arm = key.split(":")[0]
        rows.append({
            "name": f"gl_colpass[{key}]", "perf_row": "3p", "route": "cuda",
            "source": "ntt_aie_tpu_torch/csrc/gl_colpass.cu",
            "replaces": "ntt_aie_tpu/ops/pallas_gl.py:33",
            "variant": variant,
            "launches": gl_launches.get(f"{arm}:{variant}", 0),
            "max_abs_err": errs.get(f"gl:{variant}", 0),
            "ms": gl_line["pass_us_per_call"][key] / 1e3,
            "plain_ms": gl_line["plain_us_per_call"][key] / 1e3,
            "batch": B, "plain_batch": gl_line["plain_batch"],
            "bytes": 2 * B * n * 8 + tables, "table_bytes": tables,
            "butterflies": B * n // 2 * 10, "arithmetic": "goldilocks",
            "registers": info["registers"],
            "blocks_per_sm": info["blocks_per_sm"]})
    return rows


def _with_bound(row, roof):
    """row with its bound: the larger of its bytes over the data sheet's
    HBM rate and its butterflies over the measured ideal rate of its
    arithmetic; and no library call (none computes an NTT or a product
    mod p)."""
    from ntt_aie_tpu_torch.profiling import roofline as RL

    rate = roof["bfly_per_sec"].get(row.get("arithmetic"))
    bound = RL.roofline_bound(row["bytes"], row["butterflies"],
                              hbm_gbps=SPEC_HBM_GBPS, bfly_per_sec=rate)
    return dict(row, **bound, time_over_bound=row["ms"] / bound["bound_ms"],
                library_ms=None)


def _plain_batch_time(fn, x, batch):
    """Time fn on the first pb rows of x (a tensor or a limb pair),
    halving pb on device OOM (the plain versions' int64 carriers take 8
    bytes a word)."""
    import torch

    from ntt_aie_tpu_torch.utils.timing import time_device

    pb = batch
    while True:
        try:
            xp = (tuple(v[:pb] for v in x) if isinstance(x, tuple)
                  else x[:pb])
            return time_device(fn, xp, iters=2, repeats=3)["us_per_iter"], pb
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            if pb == 1:
                raise
            pb //= 2


def goldilocks_phases(args, dev, card, rng):
    """Phases 6-8: the Goldilocks path. Returns its rows of the kernels
    line, or None after emitting the failure."""
    import dataclasses

    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle, reference
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    field = T.GOLDILOCKS
    p = field.p
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def planes(shape):
        """Canonical random Goldilocks values as (hi, lo) int32 planes:
        hi = 0xffffffff allows only lo = 0 (p - 1)."""
        hi, lo = (M.from_carrier(torch.randint(0, 1 << 32, shape,
                                               dtype=torch.int64, device=dev,
                                               generator=gen))
                  for _ in range(2))
        return hi, torch.where(hi == -1, torch.zeros_like(lo), lo)

    def pair_err(got, want):
        return max(int((g.long() - w.long()).abs().max())
                   for g, w in zip(got, want))

    # 6. gl_kernel: kernel against plain on the card, at the build's one
    # register group size
    max_err = 0
    for n1, n2 in GL_KERNEL_SHAPES:
        for name, cp in gl_fold_passes(field, n1, n2, device=dev).items():
            rows, cols = (n1, n2) if name in ("cp1", "icp1") else (n2, n1)
            x = planes((4, rows, cols))
            got = G.gl_colpass(x, cp)
            torch.cuda.synchronize()
            err = pair_err(got, G.gl_colpass_plain(x, cp))
            max_err = max(max_err, err)
            emit({"phase": "gl_kernel", "pass": name,
                  "shape": [4, rows, cols],
                  "network": "nested" if cp.wmid is not None else "plain",
                  "kfuse": G.kernel_info(cp, cols)["kfuse"],
                  "max_abs_err": err})
            if err:
                fail("gl_kernel", f"{name} {rows}x{cols} differs from its "
                     "plain version")
                return None
    # 8,192 rows: the whole-column launch (2-column tiles, which the plans
    # no longer run) and the plans' tall route
    for direction in ("dif", "dit"):
        cp = G.make_gl_colpass(field, 8192, direction=direction,
                               inverse_tw=direction == "dit", device=dev)
        x = planes((1, 8192, 64))
        want = G.gl_colpass_plain(x, cp)
        for route in (dataclasses.replace(cp, tall=None), cp):
            got = G.gl_colpass(x, route)
            torch.cuda.synchronize()
            err = pair_err(got, want)
            max_err = max(max_err, err)
            info = G.kernel_info(route, 64)
            emit({"phase": "gl_kernel", "pass": direction,
                  "shape": [1, 8192, 64],
                  "route": "whole" if route.tall is None else "tall",
                  "tile_cols": [i["tile_cols"] for i in
                                info.get("phases", [info])],
                  "max_abs_err": err})
            if err:
                fail("gl_kernel", f"{direction} over 8192 rows differs from "
                     "its plain version")
                return None
    edges = np.array([0, 1, p - 1, p - 2, (1 << 32) - 1, 1 << 32,
                      0xFFFFFFFF << 32], dtype=np.uint64)
    ea, eb = (M.gl_from_u64(v.ravel(), dev) for v in np.meshgrid(edges, edges))
    a, b = planes((1 << 20,)), planes((1 << 20,))
    a = tuple(torch.cat([u, v]) for u, v in zip(a, ea))
    b = tuple(torch.cat([u, v]) for u, v in zip(b, eb))
    got = G.gl_mul(a, b)
    torch.cuda.synchronize()
    mul_err = pair_err(got, G.gl_mul_plain(a, b))
    ua, ub = M.gl_to_u64(*ea), M.gl_to_u64(*eb)
    edges_ok = M.gl_to_u64(*got)[-len(ua):].tolist() == [
        int(u) * int(v) % p for u, v in zip(ua, ub)]
    emit({"phase": "gl_kernel", "kernel": "gl_mul",
          "n": int(got[0].numel()), "max_abs_err": mul_err,
          "edges_ok": edges_ok})
    if mul_err or not edges_ok:
        fail("gl_kernel", "the pointwise product differs from its plain "
             "version or from Python on the edges")
        return None

    # 7. gl_slice: the Goldilocks path at n = 2^20, B = 64 (rows_log2 = 10
    # is the split NTTConfig picks for n = 2^20 on its own)
    cfg = T.NTTConfig(field=field, log_n=GL_LOG_N, rows_log2=GL_LOG_N // 2)
    n, (n1, n2) = cfg.n, cfg.split
    B = GL_BATCH
    plan = T.build_plan(cfg, device=dev)
    bat = plan.make_batched(B)
    x = planes((B, n1, n2))
    launches = {}

    def drive(key, fn, *operands):
        G.gl_colpass.launches = G.gl_mul.launches = 0
        out = fn(*operands)
        torch.cuda.synchronize()
        launches[key] = [G.gl_colpass.launches, G.gl_mul.launches]
        return out

    y = drive("fwd_mat", bat["fwd_mat"], x)
    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
    idx = torch.from_numpy(gate_rows).to(dev)
    got = M.gl_to_u64(*(v.reshape(B, n)[idx] for v in y))
    rows_in = M.gl_to_u64(*(v.reshape(B, n)[idx] for v in x))
    omega = field.root_of_unity(n)
    try:
        want = native_oracle.ntt_dif_batch(
            rows_in, omega, p)[:, tw.bit_reverse_indices(n)]
        oracle = "native"
    except (native_oracle.NativeOracleUnavailable, OSError):
        want = np.stack([reference.ntt_forward(r, field) for r in rows_in])
        oracle = "numpy"
    gate_ok = np.array_equal(got[:, plan.spectral_to_natural].astype(object),
                             want.astype(object))

    back = drive("inv_mat", bat["inv_mat"], y)
    roundtrip_ok = all(torch.equal(u, v) for u, v in zip(back, x))
    del back

    bat2 = plan.make_batched(2)
    pa, pb_ = tuple(v[:2] for v in x), tuple(v[2:4] for v in x)
    c = drive("polymul_mat", bat2["polymul_mat"], pa, pb_)
    ra, rb = (M.gl_to_u64(*(v[0].reshape(n) for v in t)) for t in (pa, pb_))
    c0 = M.gl_to_u64(*(v[0].reshape(n) for v in c))
    if oracle == "native":
        want_c = native_oracle.cyclic_polymul(ra, rb, omega, p)
    else:
        want_c = reference.cyclic_polymul(ra, rb, field)
    poly_ok = np.array_equal(c0.astype(object), want_c.astype(object))
    counts_ok = launches == {"fwd_mat": [2, 0], "inv_mat": [2, 0],
                             "polymul_mat": [6, 1]}
    ok = bool(gate_ok and roundtrip_ok and poly_ok and counts_ok)
    emit({"phase": "gl_slice", "n": n, "split": [n1, n2], "batch": B,
          "reduction": plan.reduction, "oracle": oracle,
          "gate_rows": gate_rows.tolist(), "gate_ok": bool(gate_ok),
          "roundtrip_ok": roundtrip_ok, "polymul_ok": bool(poly_ok),
          "launches": launches, "launches_ok": counts_ok, "ok": ok})
    if not ok:
        fail("gl_slice", "the Goldilocks path disagrees with its oracles")
        return None

    # 8. gl_time: kernel path at B = 64, plain path at B = 64 or less
    cp1, cp2 = plan.passes["cp1"], plan.passes["cp2"]
    k_fwd = time_device(bat["fwd_mat"], x)["us_per_iter"]
    k_cp1 = time_device(cp1, x)["us_per_iter"]
    k_cp2 = time_device(cp2, x)["us_per_iter"]
    k_mul = time_device(lambda v: G.gl_mul(v, v), y)["us_per_iter"]
    info = {name: G.kernel_info(cp, x[0].shape[2])
            for name, cp in (("cp1", cp1), ("cp2", cp2))}
    p_fwd, pb = _plain_batch_time(
        lambda v: G.gl_colpass_plain(G.gl_colpass_plain(v, cp1), cp2), x, B)
    p_cp1, _ = _plain_batch_time(lambda v: G.gl_colpass_plain(v, cp1), x, pb)
    p_cp2, _ = _plain_batch_time(lambda v: G.gl_colpass_plain(v, cp2), x, pb)
    p_mul, mb = _plain_batch_time(lambda v: G.gl_mul_plain(v, v), y, B)
    emit({"phase": "gl_time", "card": card, "batch": B, "plain_batch": pb,
          "kernel_us_per_ntt": k_fwd / B, "plain_us_per_ntt": p_fwd / pb,
          "kernel_cp1_us_per_pass": k_cp1 / B,
          "kernel_cp2_us_per_pass": k_cp2 / B,
          "plain_cp1_us_per_pass": p_cp1 / pb,
          "plain_cp2_us_per_pass": p_cp2 / pb,
          "kernel_gl_mul_us_per_ntt": k_mul / B,
          "plain_gl_mul_us_per_ntt": p_mul / mb, "plain_gl_mul_batch": mb,
          "kernel_ntt_per_s": B / (k_fwd * 1e-6), "kernel_info": info,
          "method": "CUDA events; kernel: 5 repeats of a dependent chain of "
                    "10, plain: 3 repeats of 2; trimmed mean; us per NTT = "
                    "us per call / batch"})
    return [
        {"name": "gl_colpass", "route": "cuda",
         "source": "ntt_aie_tpu_torch/csrc/gl_colpass.cu",
         "replaces": "ntt_aie_tpu/ops/pallas_gl.py:33",
         "launches": sum(v[0] for v in launches.values()),
         "max_abs_err": max_err, "ms": k_fwd / 2 / 1e3,
         "plain_ms": p_fwd / 2 / 1e3, "batch": B, "plain_batch": pb,
         "bytes": (4 * B * n * 8 + n * 8) / 2,
         "butterflies": B * n // 2 * 10, "arithmetic": "goldilocks",
         "kfuse": info["cp1"]["kfuse"], "registers": info["cp1"]["registers"],
         "blocks_per_sm": info["cp1"]["blocks_per_sm"]},
        {"name": "gl_mul", "route": "cuda",
         "source": "ntt_aie_tpu_torch/csrc/gl_colpass.cu",
         "replaces": "ntt_aie_tpu/goldilocks_plan.py:462 (XLA pointwise "
                     "product, not a TPU kernel)",
         "launches": sum(v[1] for v in launches.values()),
         "max_abs_err": mul_err, "ms": k_mul / 1e3, "plain_ms": p_mul / 1e3,
         "batch": B, "plain_batch": mb,
         "bytes": 2 * B * n * 8,  # gl_mul(v, v): one input, one output
         "butterflies": 0, "arithmetic": None},
    ]


def _turns(fns, x):
    """us per call of each of fns on x, timed in turns 0, 1, .., k - 1,
    k - 1, .., 0; each reading is time_device's trimmed mean, and each
    result the mean of its two readings."""
    from ntt_aie_tpu_torch.utils.timing import time_device

    acc = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        acc[i].append(time_device(fns[i], x)["us_per_iter"])
    return [sum(r) / 2 for r in acc]


def fused_phases(args, dev, card, rng):
    """Phases 9-11: the fused plan. Returns its row of the kernels line,
    or None after emitting the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle, reference
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import pointwise as PW
    from ntt_aie_tpu_torch.plan import fused_passes
    from ntt_aie_tpu_torch.utils.timing import time_device

    field = T.P_469762049
    p = field.p
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)

    # 9. fused_kernel: kernel against plain on the card
    max_err = 0
    for n1, n2 in FUSED_KERNEL_SHAPES:
        for name, ff in fused_passes(field, n1, n2, negacyclic=True,
                                     device=dev).items():
            for B in (1, 4):
                x = torch.randint(0, 4 * p, (B,) + ff.shape_in,
                                  dtype=torch.int64, device=dev,
                                  generator=gen).to(torch.int32)
                got = F.fused_fourstep(x, ff)
                torch.cuda.synchronize()
                err = int((got.long() - F.fused_fourstep_plain(x, ff).long())
                          .abs().max())
                max_err = max(max_err, err)
                emit({"phase": "fused_kernel", "transform": name,
                      "shape": [B, *ff.shape_in],
                      "networks": ["nested" if net.wmid is not None
                                   else "plain"
                                   for net in (ff.net_a, ff.net_b)],
                      "max_abs_err": err})
                if err:
                    fail("fused_kernel", f"{name} {ff.shape_in} B={B} "
                         "differs from its plain version")
                    return None
            # ten more launches at B = 1 and 4 in turn: a tile counter left
            # above zero would make the next launch skip tiles
            xs = [torch.randint(0, 4 * p, (B,) + ff.shape_in,
                                dtype=torch.int64, device=dev,
                                generator=gen).to(torch.int32)
                  for B in (1, 4)]
            for i in range(10):
                F.fused_fourstep(xs[i % 2], ff)
            torch.cuda.synchronize()
            # phase B's is reset by the next launch
            counters = ff.counters(
                torch.cuda.current_stream(dev).cuda_stream).tolist()
            err = max(int((F.fused_fourstep(v, ff).long()
                           - F.fused_fourstep_plain(v, ff).long()).abs().max())
                      for v in xs)
            max_err = max(max_err, err)
            emit({"phase": "fused_kernel", "transform": name,
                  "shape": list(ff.shape_in), "after_chain": 10,
                  "batches": [1, 4], "counters": counters,
                  "max_abs_err": err})
            if err or counters[0] != 0:
                fail("fused_kernel", f"{name} {ff.shape_in} after a chain "
                     "differs from its plain version or left its counters "
                     f"at {counters}")
                return None

    # 10. fused_slice: the fused plan at n = 2^20 against the fold plan and
    # the oracles
    cfg = T.NTTConfig(field=field, log_n=20, negacyclic=True)
    n, (n1, n2) = cfg.n, cfg.split
    B = 256
    plan = T.build_plan(cfg, device=dev, fused=True)
    fold = T.build_plan(T.NTTConfig(field=field, log_n=20), device=dev)
    bat, fold_bat = plan.make_batched(B), fold.make_batched(B)
    bat2 = plan.make_batched(2)
    x = torch.randint(0, p, (B, n1, n2), dtype=torch.int32, device=dev,
                      generator=gen)
    launches = {}

    def drive(key, fn, *operands):
        C.colpass.launches = F.fused_fourstep.launches = 0
        PW.mul32.launches = 0
        out = fn(*operands)
        torch.cuda.synchronize()
        launches[key] = [F.fused_fourstep.launches, C.colpass.launches,
                         PW.mul32.launches]
        return out

    y1 = drive("fwd_mat", plan.fwd_mat, x[0])
    y = drive("fwd_mat_b256", bat["fwd_mat"], x)
    back = drive("inv_mat", bat["inv_mat"], y)
    a, b = x[:2], x[2:4]
    c = drive("polymul_mat", bat2["polymul_mat"], a, b)
    d = drive("negacyclic_polymul_mat", bat2["negacyclic_polymul_mat"], a, b)

    fold_ok = (torch.equal(y1, fold.fwd_mat(x[0]))
               and torch.equal(y, fold_bat["fwd_mat"](x)))
    roundtrip_ok = bool(torch.equal(back, x))
    del back
    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
    idx = torch.from_numpy(gate_rows).to(dev)
    got = y.reshape(B, n)[idx].cpu().numpy()
    rows_in = x.reshape(B, n)[idx].cpu().numpy().astype(np.uint64)
    a0, b0 = (v[0].reshape(n).cpu().numpy().astype(np.uint64)
              for v in (a, b))
    omega, psi = field.root_of_unity(n), field.root_of_unity(2 * n)
    try:
        want = native_oracle.ntt_dif_batch(
            rows_in, omega, p)[:, tw.bit_reverse_indices(n)]
        want_c = native_oracle.cyclic_polymul(a0, b0, omega, p)
        want_d = native_oracle.negacyclic_polymul(a0, b0, psi, p)
        oracle = "native"
    except (native_oracle.NativeOracleUnavailable, OSError):
        want = np.stack([reference.ntt_forward(r, field) for r in rows_in])
        want_c = reference.cyclic_polymul(a0, b0, field)
        want_d = reference.negacyclic_polymul(a0, b0, field)
        oracle = "numpy"
    gate_ok = np.array_equal(
        got[:, plan.spectral_to_natural].astype(np.uint64),
        want.astype(np.uint64))
    poly_ok = np.array_equal(
        c[0].reshape(n).cpu().numpy().astype(np.uint64),
        want_c.astype(np.uint64))
    d0 = d[0].reshape(n).cpu().numpy().astype(np.int64)
    nega_ok = np.array_equal(d0.astype(np.uint64), want_d.astype(np.uint64))
    # c_k = sum_{i<=k} a_i b_(k-i) - sum_{i>k} a_i b_(n+k-i): shares
    # nothing with the psi scaling
    ai, bi = a0.astype(np.int64), b0.astype(np.int64)
    coeffs = rng.choice(n, size=8, replace=False)
    direct = [int((ai[:k + 1] * bi[k::-1] % p).sum()
                  - (ai[k + 1:] * bi[:k:-1] % p).sum()) % p for k in coeffs]
    direct_ok = direct == [int(d0[k]) for k in coeffs]
    counts_ok = launches == {"fwd_mat": [1, 0, 0], "fwd_mat_b256": [1, 0, 0],
                             "inv_mat": [1, 0, 0], "polymul_mat": [3, 0, 1],
                             "negacyclic_polymul_mat": [3, 0, 1]}
    ok = bool(fold_ok and roundtrip_ok and gate_ok and poly_ok and nega_ok
              and direct_ok and counts_ok)
    emit({"phase": "fused_slice", "n": n, "split": [n1, n2], "batch": B,
          "reduction": plan.reduction, "oracle": oracle,
          "equals_fold_plan": bool(fold_ok), "gate_rows": gate_rows.tolist(),
          "gate_ok": bool(gate_ok), "roundtrip_ok": roundtrip_ok,
          "polymul_ok": bool(poly_ok), "negacyclic_ok": bool(nega_ok),
          "direct_coeffs": coeffs.tolist(), "direct_ok": direct_ok,
          "launches": launches, "launches_ok": counts_ok, "ok": ok})
    if not ok:
        fail("fused_slice", "the fused path disagrees with its oracles")
        return None

    # 11. fused_time: fused against fold in turns, and the plain version
    fold1, fused1 = _turns((fold.fwd_mat, plan.fwd_mat), x[0])
    fold_inv1, fused_inv1 = _turns((fold.inv_mat, plan.inv_mat), x[0])
    foldb, fusedb = _turns((fold_bat["fwd_mat"], bat["fwd_mat"]), x)
    fold_invb, fused_invb = _turns((fold_bat["inv_mat"], bat["inv_mat"]), x)
    ff = plan.passes["ff"]
    info = F.kernel_info(ff, B)
    # after the timed chains: the same plan against the fold plan again
    y = bat["fwd_mat"](x)
    chain_ok = bool(torch.equal(y, fold_bat["fwd_mat"](x))
                    and torch.equal(bat["inv_mat"](y), x))
    del y

    def plain(v):
        return F.fused_fourstep_plain(v, ff)

    plain1 = time_device(plain, x[0])["us_per_iter"]
    plainb, pb = _plain_batch_time(plain, x, B)
    emit({"phase": "fused_time", "card": card,
          "fused_fwd_mat_us_per_ntt": {"1": fused1, "256": fusedb / B},
          "fold_fwd_mat_us_per_ntt": {"1": fold1, "256": foldb / B},
          "fused_inv_mat_us_per_ntt": {"1": fused_inv1,
                                       "256": fused_invb / B},
          "fold_inv_mat_us_per_ntt": {"1": fold_inv1, "256": fold_invb / B},
          "plain_fused_fwd_us_per_ntt": {"1": plain1, str(pb): plainb / pb},
          "kfuse": info["kfuse"], "blocks_per_sm": info["blocks_per_sm"],
          "registers": info["registers"], "grid": info["grid"],
          "equals_fold_after_chain": chain_ok,
          "method": "CUDA events, 5 repeats of a dependent chain of 10, "
                    "trimmed mean; fold and fused timed in turns (fold, "
                    "fused, fused, fold), mean of the two readings; plain "
                    "at B > 1: 3 repeats of 2; us per NTT = us per call / "
                    "batch"})
    if not chain_ok:
        fail("fused_time", "after the timed chains the fused plan differs "
             "from the fold plan")
        return None
    # the row's kernel and plain times are at B = 256: a chained B = 1
    # reading is bound by the host's enqueue, not by the kernel (PERF.md)
    return {"name": "fused_fourstep", "route": "cuda",
            "source": "ntt_aie_tpu_torch/csrc/fused_fourstep.cu",
            "replaces": "ntt_aie_tpu/ops/pallas_ntt.py:693",
            "launches": sum(v[0] for v in launches.values()),
            "max_abs_err": max_err, "ms": fusedb / 1e3,
            "inv_ms": fused_invb / 1e3,
            "kfuse": info["kfuse"], "blocks_per_sm": info["blocks_per_sm"],
            "plain_ms": plainb / 1e3, "batch": B, "plain_batch": pb,
            "ms_batch_1": fused1 / 1e3, "plain_ms_batch_1": plain1 / 1e3,
            # x and out at B = 256 and the (w, packed) wmid; the scratch
            # between the phases is the kernel's own traffic
            "bytes": 2 * B * n * 4 + 2 * n * 4,
            "butterflies": B * n // 2 * 20, "arithmetic": "harvey4",
            "pointwise32_launches": sum(v[2] for v in launches.values())}


def nested_phases(args, dev, card):
    """Phases 12-14: the nested R x S column pass's kernel, check and
    bench. Returns its rows of the kernels line (nested_colpass and
    bfly_probe), or None after emitting the failure."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import nested_colpass as N
    from ntt_aie_tpu_torch.profiling import roofline as RL
    from ntt_aie_tpu_torch.scripts import proto_nested_colpass as S
    from ntt_aie_tpu_torch.utils.timing import time_device

    p = T.P_469762049.p
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)

    # 12. nested_kernel: kernel against plain (and the column pass's
    # kernel where it nests the same way)
    max_err = 0
    for batch, n1, n2, R, fuse in NESTED_KERNEL_CASES:
        nc, meta = N.make_nested_colpass(n1, n2, R=R, batch=batch, fuse=fuse,
                                         device=dev)
        x = torch.randint(0, 4 * p, nc.shape, dtype=torch.int64, device=dev,
                          generator=gen).to(torch.int32)
        got = N.nested_colpass(x, nc)
        torch.cuda.synchronize()
        err = int((got.long() - N.nested_colpass_plain(x, nc).long())
                  .abs().max())
        max_err = max(max_err, err)
        line = {"phase": "nested_kernel", "shape": list(nc.shape),
                "R": meta["R"], "S": meta["S"], "fuse": fuse,
                "max_abs_err": err}
        if (n1, n2) == (1024, 1024):
            cp = C.make_colpass(T.P_469762049, n1, direction="dif",
                                device=dev)
            line["equals_colpass_kernel"] = bool(torch.equal(
                got, C.colpass(x, cp)))
            err = err or int(not line["equals_colpass_kernel"])
        emit(line)
        if err:
            fail("nested_kernel", f"B={batch} {n1}x{n2} R={meta['R']} "
                 f"fuse={fuse} differs from its plain version or the "
                 "column pass")
            return None

    # 13-14. the script's check and bench: the slice's main path
    C.colpass.launches = N.nested_colpass.launches = 0
    RL.probe_chain.launches = 0
    check = S.check()
    lines = S.bench(NESTED_BATCH, NESTED_CHAIN)
    torch.cuda.synchronize()
    launches = {"nested_colpass": N.nested_colpass.launches,
                "bfly_probe": RL.probe_chain.launches,
                "colpass": C.colpass.launches}
    emit({"phase": "nested_check", "ok": check["check"] == "ok",
          "R": check["R"], "S": check["S"]})
    by_fuse = {ln["fuse"]: ln["us_per_call"] for ln in lines[1:]
               if ln.get("fuse")}
    colpass_us = next(ln["us_per_call"] for ln in lines[1:]
                      if ln.get("fuse") is None)
    launches_ok = all(v > 0 for v in launches.values())
    infos = {f: N.kernel_info(N.make_nested_colpass(
        S.BENCH_N1, S.BENCH_N2, batch=NESTED_BATCH, fuse=f, device=dev)[0])
        for f in by_fuse}

    # the plain versions at the bench's shapes
    nc, _ = N.make_nested_colpass(S.BENCH_N1, S.BENCH_N2,
                                  batch=NESTED_BATCH, device=dev)
    x = torch.randint(0, p, nc.shape, dtype=torch.int32, device=dev,
                      generator=gen)
    plain_us = time_device(lambda v: N.nested_colpass_plain(v, nc), x,
                           iters=2, repeats=3)["us_per_iter"]
    del x
    px, ptw = RL.probe_inputs("harvey4", 32 * 1024 * 1024 // 4, device=dev)
    probe_r = 64
    probe_plain_us = time_device(
        lambda v: RL.probe_chain_plain(v, ptw, r=probe_r), px, iters=2,
        repeats=3)["us_per_iter"]
    ideal = lines[0]
    emit({"phase": "nested_bench", "card": card, "batch": NESTED_BATCH,
          "chain": NESTED_CHAIN, "probe_gbf": ideal["gbf"],
          "probe_dispatch_us": ideal["dispatch_us"],
          "colpass_us_per_call": colpass_us,
          "nested_us_per_call_by_fuse": by_fuse,
          "kernel_info_by_fuse": infos,
          "plain_nested_us_per_call": plain_us,
          "plain_probe_us_per_launch": probe_plain_us,
          "launches": launches, "launches_ok": launches_ok,
          "method": "CUDA events; time_device(iters=3, repeats=4) of a "
                    "dependent chain of 8 calls, trimmed mean, / 8; plain: "
                    "iters=2, repeats=3"})
    if not launches_ok:
        fail("nested_bench", f"a kernel of the path did not launch: "
             f"{launches}")
        return None
    n = S.BENCH_N1 * S.BENCH_N2
    net = nc.net
    probe_words = px.numel()
    return [
        {"name": "nested_colpass", "route": "cuda",
         "source": "ntt_aie_tpu_torch/csrc/nested_colpass.cu",
         "replaces": "scripts/proto_nested_colpass.py:48",
         "launches": launches["nested_colpass"], "max_abs_err": max_err,
         "ms": by_fuse[nc.fuse] / 1e3, "fuse": nc.fuse,
         "ms_by_fuse": {f: us / 1e3 for f, us in by_fuse.items()},
         "colpass_ms_same_shape": colpass_us / 1e3,
         "regs_by_fuse": {f: i["registers"] for f, i in infos.items()},
         "blocks_per_sm_by_fuse": {f: i["blocks_per_sm"]
                                   for f, i in infos.items()},
         "plain_ms": plain_us / 1e3, "batch": NESTED_BATCH,
         "plain_batch": NESTED_BATCH,
         "bytes": 2 * NESTED_BATCH * n * 4
         + 4 * (net.tw.numel() + net.wmid.numel()),
         "butterflies": NESTED_BATCH * n // 2 * 10,
         "arithmetic": "harvey4"},
        {"name": "bfly_probe", "route": "cuda",
         "source": "ntt_aie_tpu_torch/csrc/bfly_probe.cu",
         "replaces": "ntt_aie_tpu/profiling/roofline.py:128 (the probe "
                     "chain of measure_vpu_peak, under XLA: not a TPU "
                     "kernel)",
         "launches": launches["bfly_probe"], "max_abs_err": None,
         "ms": None, "plain_ms": probe_plain_us / 1e3, "r": probe_r,
         "batch": None, "plain_batch": None,
         "bytes": 2 * probe_words * 4 + 4 * ptw.numel(),
         "butterflies": probe_r * probe_words // 2,
         "arithmetic": "harvey4"},
    ]


def batch_split_phase(args, dev) -> bool:
    """Phase 16: each column kernel at a batch of 65,537 (two launches)
    against its plain version. Returns False after emitting the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.ops import nested_colpass as N

    p = T.P_469762049.p
    batch = C.MAX_LAUNCH_BATCH + 2
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    rng = np.random.default_rng(args.seed + 4)

    def lazy(shape):
        return torch.randint(0, 4 * p, shape, dtype=torch.int64, device=dev,
                             generator=gen).to(torch.int32)

    cp = C.make_colpass(T.P_469762049, 32, direction="dif", device=dev)
    gl = G.make_gl_colpass(T.GOLDILOCKS, 32, direction="dit",
                           inverse_tw=True, device=dev)
    nc, _ = N.make_nested_colpass(32, 4, batch=batch, device=dev)
    glx = M.gl_from_u64(rng.integers(0, 1 << 64, (batch, 32, 4),
                                     dtype=np.uint64)
                        % np.uint64(T.GOLDILOCKS.p), dev)
    cases = (("colpass", C.colpass, C.colpass_plain, cp, lazy((batch, 32, 4))),
             ("gl_colpass", G.gl_colpass, G.gl_colpass_plain, gl, glx),
             ("nested_colpass", N.nested_colpass, N.nested_colpass_plain, nc,
              lazy(nc.shape)))
    ok = True
    for name, fn, plain, op, x in cases:
        before = fn.launches
        got = fn(x, op)
        torch.cuda.synchronize()
        want = plain(x, op)
        got, want = ((got,), (want,)) if name != "gl_colpass" else (got, want)
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        launches = fn.launches - before
        emit({"phase": "batch_split", "kernel": name,
              "shape": list((x[0] if name == "gl_colpass" else x).shape),
              "launches": launches, "max_abs_err": err})
        ok = ok and not err and launches == 2
    if not ok:
        fail("batch_split", "a column kernel at batch 65,537 differs from "
             "its plain version or did not take two launches")
    return ok


def roofline_phase(dev, card):
    """Phase 15: the card's measured HBM rate and ideal butterfly rates,
    and the probe kernel against its plain version. Returns {"hbm_gbps",
    "bfly_per_sec": {arithmetic: rate}, "probe": {...}}, or None after
    emitting the failure."""
    import torch

    from ntt_aie_tpu_torch.profiling import roofline as RL

    peak = RL.measure_peak(device=dev)
    emit(dict(peak, phase="roofline", probe="hbm", card=card))
    rates, probe = {}, {}
    for red in ("harvey4", "goldilocks", "harvey", "montgomery", "barrett"):
        x, tw = RL.probe_inputs(red, 32 * 1024 * 1024 // 4, device=dev)
        got = RL.probe_chain(x, tw, r=64, reduction=red)
        torch.cuda.synchronize()
        err = int((got.long() - RL.probe_chain_plain(
            x, tw, r=64, reduction=red).long()).abs().max())
        del x, got
        for r in (64, 128) if red in ("harvey4", "goldilocks") else (64,):
            out = RL.measure_vpu_peak(reduction=red, r=r, device=dev)
            emit(dict(out, phase="roofline", probe="butterflies", card=card,
                      max_abs_err_r64=err))
            if r == 64:
                rates[red] = out["butterflies_per_sec"]
                probe[red] = dict(out, max_abs_err=err)
        if err:
            fail("roofline", f"the {red} probe kernel differs from its plain "
                 "version")
            return None
    return {"hbm_gbps": peak["measured_hbm_gbps"], "bfly_per_sec": rates,
            "probe": probe}


def _domain_top(kind: str, p: int) -> int:
    """The top of a reduction's travel domain: a column kernel's input."""
    return {"harvey4": 4 * p, "harvey": 2 * p}.get(kind, p)


def red_kernel_phase(kind, field, dev, gen):
    """Phase 17 for one reduction: its column and fused kernels against
    their plain versions. Returns the largest error, or None after emitting
    the failure."""
    import torch

    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.plan import fold_passes, fused_passes

    top = _domain_top(kind, field.p)
    max_err = 0

    def held(what, name, got, want, shape):
        nonlocal max_err
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        emit({"phase": "red_kernel", "reduction": kind, "kernel": what,
              "pass": name, "shape": list(shape), "max_abs_err": err})
        if err or not torch.equal(got, want):
            fail("red_kernel", f"{kind} {what} {name} {shape} differs from "
                 "its plain version")
            return False
        return True

    for n1, n2 in RED_KERNEL_SHAPES[kind]:
        n = n1 * n2
        if n <= field.max_n:
            for name, cp in fold_passes(field, n1, n2, reduction=kind,
                                        device=dev).items():
                for B in (1, 4):
                    shape = (B,) + ((n1, n2) if name in ("cp1", "icp1")
                                    else (n2, n1))
                    x = torch.randint(0, top, shape, dtype=torch.int64,
                                      device=dev, generator=gen)
                    x = x.to(torch.int32)
                    got = C.colpass(x, cp)
                    torch.cuda.synchronize()
                    if not held("colpass", name, got, C.colpass_plain(x, cp),
                                shape):
                        return None
        nega = 2 * n <= field.max_n
        fused = fused_passes(field, n1, n2, negacyclic=nega, reduction=kind,
                             device=dev)
        for name, ff in fused.items():
            for B in (1, 4):
                x = torch.randint(0, top, (B,) + ff.shape_in,
                                  dtype=torch.int64, device=dev,
                                  generator=gen).to(torch.int32)
                got = F.fused_fourstep(x, ff)
                torch.cuda.synchronize()
                if not held("fused_fourstep", name, got,
                            F.fused_fourstep_plain(x, ff), x.shape):
                    return None
    return max_err


def red_slice_phase(kind, field, log_n, rows_log2, B, dev, gen, rng):
    """Phase 18 for one reduction: its fold and fused plans at full width
    against the native oracle. Returns (fold plan, fused plan, x, launch
    counts), or None after emitting the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import pointwise as PW

    p = field.p
    cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2,
                      reduction=kind)
    n, (n1, n2) = cfg.n, cfg.split
    fold = T.build_plan(cfg, device=dev)
    fused = T.build_plan(cfg, device=dev, fused=True)
    # the negacyclic product needs a 2n-th root: Kyber's largest is n = 128
    nega_log_n = log_n if 2 * n <= field.max_n else log_n - 1
    ncfg = T.NTTConfig(field=field, log_n=nega_log_n, rows_log2=rows_log2,
                       reduction=kind, negacyclic=True)
    nega = T.build_plan(ncfg, device=dev, fused=True)
    x = torch.randint(0, p, (B, n1, n2), dtype=torch.int32, device=dev,
                      generator=gen)
    launches = {}

    def drive(key, fn, *operands):
        C.colpass.launches = F.fused_fourstep.launches = 0
        PW.mul32.launches = 0
        out = fn(*operands)
        torch.cuda.synchronize()
        launches[key] = [C.colpass.launches, F.fused_fourstep.launches,
                         PW.mul32.launches]
        return out

    fb, ub = fold.make_batched(B), fused.make_batched(B)
    y = drive("fold_fwd_mat", fb["fwd_mat"], x)
    yf = drive("fused_fwd_mat", ub["fwd_mat"], x)
    fused_ok = bool(torch.equal(y, yf))
    del yf
    back = drive("fold_inv_mat", fb["inv_mat"], y)
    roundtrip_ok = bool(torch.equal(back, x))
    del back
    back = drive("fused_inv_mat", ub["inv_mat"], y)
    roundtrip_ok = roundtrip_ok and bool(torch.equal(back, x))
    del back

    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
    idx = torch.from_numpy(gate_rows).to(dev)
    got = y.reshape(B, n)[idx].cpu().numpy().astype(np.uint64)
    rows_in = x.reshape(B, n)[idx].cpu().numpy().astype(np.uint64)
    omega = field.root_of_unity(n)
    want = native_oracle.ntt_dif_batch(rows_in, omega, p)[
        :, tw.bit_reverse_indices(n)]
    gate_ok = np.array_equal(got[:, fold.spectral_to_natural],
                             want.astype(np.uint64))
    del y

    a, b = x[:2], x[2:4]
    c = drive("fold_polymul_mat", fold.make_batched(2)["polymul_mat"], a, b)
    cf = drive("fused_polymul_mat", fused.make_batched(2)["polymul_mat"], a,
               b)
    poly_ok = bool(torch.equal(c, cf))
    for r in range(2):
        want_c = native_oracle.cyclic_polymul(
            a[r].reshape(n).cpu().numpy(), b[r].reshape(n).cpu().numpy(),
            omega, p)
        poly_ok = poly_ok and np.array_equal(
            c[r].reshape(n).cpu().numpy().astype(np.uint64),
            want_c.astype(np.uint64))
    nn_, (m1, m2) = ncfg.n, ncfg.split
    na = torch.randint(0, p, (2, m1, m2), dtype=torch.int32, device=dev,
                       generator=gen)
    nb = torch.randint(0, p, (2, m1, m2), dtype=torch.int32, device=dev,
                       generator=gen)
    d = drive("fused_negacyclic_polymul_mat",
              nega.make_batched(2)["negacyclic_polymul_mat"], na, nb)
    psi = field.root_of_unity(2 * nn_)
    nega_ok = all(np.array_equal(
        d[r].reshape(nn_).cpu().numpy().astype(np.uint64),
        native_oracle.negacyclic_polymul(
            na[r].reshape(nn_).cpu().numpy(),
            nb[r].reshape(nn_).cpu().numpy(), psi, p).astype(np.uint64))
        for r in range(2))
    counts_ok = launches == {
        "fold_fwd_mat": [2, 0, 0], "fused_fwd_mat": [0, 1, 0],
        "fold_inv_mat": [2, 0, 0], "fused_inv_mat": [0, 1, 0],
        "fold_polymul_mat": [6, 0, 1], "fused_polymul_mat": [0, 3, 1],
        "fused_negacyclic_polymul_mat": [0, 3, 1]}
    ok = bool(gate_ok and fused_ok and roundtrip_ok and poly_ok and nega_ok
              and counts_ok)
    emit({"phase": "red_slice", "reduction": kind, "p": p, "n": n,
          "split": [n1, n2], "batch": B, "plan_reduction": fold.reduction,
          "oracle": "native", "gate_rows": gate_rows.tolist(),
          "gate_ok": bool(gate_ok), "fused_equals_fold": fused_ok,
          "roundtrip_ok": roundtrip_ok, "polymul_ok": bool(poly_ok),
          "negacyclic_n": nn_, "negacyclic_ok": bool(nega_ok),
          "launches": launches, "launches_ok": counts_ok, "ok": ok})
    if not ok or fold.reduction != kind:
        fail("red_slice", f"the {kind} plans disagree with their oracles "
             "or did not launch as expected")
        return None
    return fold, fused, x, launches


def red_time_phase(kind, fold, fused, x, card):
    """Phase 19 for one reduction: the kernels' and the plain versions'
    times, and kernel_info. Returns the phase's line."""
    import torch

    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.utils.timing import time_device

    B = x.shape[0]
    n = x.shape[1] * x.shape[2]
    pb = min(B, max(1, 4 * (1 << 20) // n))
    fb, ub = fold.make_batched(B), fused.make_batched(B)
    us = {}
    for plan_name, bat in (("fold", fb), ("fused", ub)):
        us[plan_name] = {
            "fwd_mat": time_device(bat["fwd_mat"], x)["us_per_iter"] / B,
            "inv_mat": time_device(bat["inv_mat"], x)["us_per_iter"] / B,
            "polymul_mat": time_device(lambda v: bat["polymul_mat"](v, v),
                                       x)["us_per_iter"] / B}
    cp1, cp2 = fold.passes["cp1"], fold.passes["cp2"]
    ff = fused.passes["ff"]
    k_cp1 = time_device(cp1, x)["us_per_iter"]
    k_cp2 = time_device(cp2, x)["us_per_iter"]
    xp = x[:pb]
    p_fwd = time_device(
        lambda v: C.colpass_plain(C.colpass_plain(v, cp1), cp2), xp,
        iters=2, repeats=3)["us_per_iter"]
    p_fused = time_device(lambda v: F.fused_fourstep_plain(v, ff), xp,
                          iters=2, repeats=3)["us_per_iter"]
    info = {"cp1": C.kernel_info(cp1, x.shape[2]),
            "cp2": C.kernel_info(cp2, x.shape[1]),
            "ff": F.kernel_info(ff, B)}
    line = {"phase": "red_time", "reduction": kind, "card": card,
            "batch": B, "n": n, "plain_batch": pb,
            "kernel_us_per_ntt": us,
            "kernel_cp1_us_per_pass": k_cp1 / B,
            "kernel_cp2_us_per_pass": k_cp2 / B,
            "plain_fold_fwd_us_per_ntt": p_fwd / pb,
            "plain_fused_fwd_us_per_ntt": p_fused / pb,
            "kernel_info": info,
            "method": "CUDA events; kernel: 5 repeats of a dependent chain "
                      "of 10, plain: 3 repeats of 2; trimmed mean; us per "
                      "NTT = us per call / batch; polymul_mat of x with "
                      "itself"}
    emit(line)
    torch.cuda.synchronize()
    return line


def reduction_phases(args, dev, card, rng):
    """Phases 17-19: the fold and fused plans under montgomery, harvey and
    barrett, and harvey against harvey4. Returns their rows of the kernels
    line, or None after emitting the failure."""
    import math

    import torch

    import ntt_aie_tpu_torch as T

    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    rows = []
    for kind, name, log_n, rows_log2, B in RED_PLANS:
        field = T.FIELDS[name]
        err = red_kernel_phase(kind, field, dev, gen)
        if err is None:
            return None
        torch.cuda.empty_cache()
        got = red_slice_phase(kind, field, log_n, rows_log2, B, dev, gen,
                              rng)
        if got is None:
            return None
        fold, fused, x, launches = got
        line = red_time_phase(kind, fold, fused, x, card)
        n = 1 << log_n
        log_nn = (log_n + 1) // 2  # stages a column pass of the split runs
        per = line["kernel_us_per_ntt"]
        pb = line["plain_batch"]
        info = line["kernel_info"]
        rows += [
            {"name": f"colpass[{kind}]", "route": "cuda",
             "source": "ntt_aie_tpu_torch/csrc/colpass.cu",
             "replaces": "ntt_aie_tpu/ops/pallas_ntt.py:298",
             "launches": sum(v[0] for v in launches.values()),
             "max_abs_err": err,
             "ms": per["fold"]["fwd_mat"] * B / 2 / 1e3,
             "plain_ms": line["plain_fold_fwd_us_per_ntt"] * pb / 2 / 1e3,
             "batch": B, "plain_batch": pb,
             "bytes": (4 * B * n * 4 + 2 * n * 4) / 2,
             "butterflies": B * n // 2 * log_nn, "arithmetic": kind,
             "p": field.p, "registers": info["cp1"]["registers"],
             "blocks_per_sm": info["cp1"]["blocks_per_sm"],
             "pointwise32_launches": sum(v[2] for v in launches.values())},
            {"name": f"fused_fourstep[{kind}]", "route": "cuda",
             "source": "ntt_aie_tpu_torch/csrc/fused_fourstep.cu",
             "replaces": "ntt_aie_tpu/ops/pallas_ntt.py:693",
             "launches": sum(v[1] for v in launches.values()),
             "max_abs_err": err,
             "ms": per["fused"]["fwd_mat"] * B / 1e3,
             "plain_ms": line["plain_fused_fwd_us_per_ntt"] * pb / 1e3,
             "batch": B, "plain_batch": pb,
             "bytes": 2 * B * n * 4 + 2 * n * 4,
             "butterflies": B * n // 2 * int(math.log2(n)),
             "arithmetic": kind, "p": field.p,
             "registers": info["ff"]["registers"],
             "blocks_per_sm": info["ff"]["blocks_per_sm"]},
        ]
        del fold, fused, x
        torch.cuda.empty_cache()

    # harvey against harvey4 on the same prime, fold and fused, in turns
    field = T.P_469762049
    x = torch.randint(0, field.p, (256, 1024, 1024), dtype=torch.int32,
                      device=dev, generator=gen)
    turns = {}
    for fused in (False, True):
        h4, h = (T.build_plan(T.NTTConfig(field=field, log_n=20,
                                          reduction=kind), device=dev,
                              fused=fused).make_batched(256)["fwd_mat"]
                 for kind in ("harvey4", "harvey"))
        same = bool(torch.equal(h4(x), h(x)))
        a_us, b_us = _turns((h4, h), x)
        turns["fused" if fused else "fold"] = {
            "harvey4_us_per_ntt": a_us / 256, "harvey_us_per_ntt": b_us / 256,
            "harvey_over_harvey4": b_us / a_us, "equal": same}
        if not same:
            fail("red_time", "harvey's fwd_mat differs from harvey4's on "
                 "p = 469762049")
            return None
    emit({"phase": "red_time", "compare": "harvey vs harvey4",
          "p": field.p, "n": 1 << 20, "batch": 256, "card": card,
          "fwd_mat": turns,
          "method": "CUDA events, 5 repeats of a dependent chain of 10, "
                    "trimmed mean; in turns harvey4, harvey, harvey, "
                    "harvey4; mean of the two readings"})
    del x
    torch.cuda.empty_cache()
    return rows


def _flat_ops(gl):
    """Helpers of the flat phases over int32 tensors or, for Goldilocks,
    (hi, lo) limb pairs: rows as uint64 host arrays, equality, a gather on
    the last axis and a slice of the batch."""
    import numpy as np
    import torch

    from ntt_aie_tpu_torch.ops import modops as M

    if gl:
        return (lambda v, idx: M.gl_to_u64(*(t[idx] for t in v)),
                lambda u, v: all(torch.equal(a, b) for a, b in zip(u, v)),
                lambda v, idx: tuple(t.index_select(-1, idx) for t in v),
                lambda v, k: tuple(t[:k] for t in v))
    return (lambda v, idx: v[idx].cpu().numpy().astype(np.uint64),
            torch.equal, lambda v, idx: v.index_select(-1, idx),
            lambda v, k: v[:k])


def flat_phase(spec, dev, card, gen, rng):
    """Phase 20, one configuration of FLAT_PLANS: its flat plans on the
    card gated bit for bit against the native oracle, their launches
    counted, and timed. Returns ({kernel row: launches}, the line), or
    None after emitting the failure."""
    import dataclasses

    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import pointwise as PW
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.ops import stages as S
    from ntt_aie_tpu_torch.utils.timing import time_device

    phase, name, log_n, B, nega_log_n = spec
    field = T.FIELDS[name]
    p, n = field.p, 1 << log_n
    gl = field.is_goldilocks
    rows_u64, same, take, head = _flat_ops(gl)
    cfg = T.NTTConfig(field=field, log_n=log_n,
                      negacyclic=nega_log_n == log_n)
    kind = cfg.resolved_reduction
    if cfg.split != (n, 1):
        fail("flat", f"{phase} {name} n = 2^{log_n} is not on the flat "
             f"split: {cfg.split}")
        return None
    kinds = ("fold",) if gl else ("fold", "fused")
    plans = {k: T.build_plan(cfg, device=dev, fused=k == "fused")
             for k in kinds}
    nat = T.build_plan(dataclasses.replace(cfg, ordering="natural"),
                       device=dev)
    if nega_log_n in (None, log_n):
        nega = plans if nega_log_n else {}
    else:
        ncfg = T.NTTConfig(field=field, log_n=nega_log_n, negacyclic=True)
        nega = {k: T.build_plan(ncfg, device=dev, fused=k == "fused")
                for k in kinds}

    def batch(rows, m):
        if gl:
            v = rng.integers(0, 1 << 64, (rows, m), dtype=np.uint64)
            return M.gl_from_u64(v % np.uint64(p), dev)
        return torch.randint(0, p, (rows, m), dtype=torch.int32, device=dev,
                             generator=gen)

    x, x2 = batch(B, n), batch(B, n)
    nn_ = 1 << (nega_log_n or log_n)
    xa, xb = (x, x2) if nn_ == n else (batch(B, nn_), batch(B, nn_))
    counters = (G.gl_colpass, G.gl_mul) if gl else (C.colpass,
                                                    F.fused_fourstep,
                                                    PW.mul32)
    launches = {}

    def drive(key, fn, *operands):
        for c in counters:
            c.launches = 0
        out = fn(*operands)
        torch.cuda.synchronize()
        launches[key] = [c.launches for c in counters]
        return out

    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
    gidx = torch.from_numpy(gate_rows).to(dev)
    omega = field.root_of_unity(n)
    xin, x2in = rows_u64(x, gidx), rows_u64(x2, gidx)
    want = native_oracle.ntt_dif_batch(xin, omega, p)
    want_c = [native_oracle.cyclic_polymul(u, v, omega, p)
              for u, v in zip(xin, x2in)]
    checks = {"gate": True, "roundtrip": True, "polymul": True}
    ys = {}
    for k in kinds:
        bat = plans[k].make_batched(B)
        ys[k] = y = drive(f"{k}_fwd", bat["fwd"], x)
        checks["gate"] &= np.array_equal(rows_u64(y, gidx), want)
        back = drive(f"{k}_inv", bat["inv"], y)
        checks["roundtrip"] &= same(back, x)
        del back
        c = drive(f"{k}_polymul", bat["polymul"], x, x2)
        checks["polymul"] &= all(np.array_equal(r, w) for r, w in
                                 zip(rows_u64(c, gidx), want_c))
        del c
        if nega:
            d = drive(f"{k}_negacyclic_polymul",
                      nega[k].make_batched(B)["negacyclic_polymul"], xa, xb)
            psi = field.root_of_unity(2 * nn_)
            checks["negacyclic"] = checks.get("negacyclic", True) and all(
                np.array_equal(r, native_oracle.negacyclic_polymul(u, v, psi,
                                                                   p))
                for r, u, v in zip(rows_u64(d, gidx), rows_u64(xa, gidx),
                                   rows_u64(xb, gidx)))
            del d
    y = ys["fold"]
    if "fused" in ys:
        checks["fused_equals_fold"] = same(ys["fused"], y)
    brev = torch.from_numpy(tw.bit_reverse_indices(n)).to(dev)
    nbat = nat.make_batched(B)
    yn = nbat["fwd"](x)
    checks["natural"] = same(yn, take(y, brev)) and same(nbat["inv"](yn), x)
    del yn
    pb = FLAT_PLAIN_BATCH
    fs = S.make_flat_stages(field, n, reduction=kind, device=dev)
    checks["plain"] = (same(fs.fwd(head(x, pb)), head(y, pb))
                       and same(fs.inv(head(y, pb)), head(x, pb)))
    if gl:
        expect = {"fwd": [2, 0], "inv": [2, 0], "polymul": [6, 1],
                  "negacyclic_polymul": [6, 4]}
        rows = {"gl_colpass": 0, "gl_mul": 1}
    else:
        # the negacyclic product is the fused plan's on both plans
        expect = {"fwd": [2, 0, 0], "inv": [2, 0, 0], "polymul": [6, 0, 1],
                  "negacyclic_polymul": [0, 3, 1]}
        expect.update({f"fused_{k}": ([0, 3, 1] if "polymul" in k
                                      else [0, 1, 0])
                       for k in list(expect)})
        suffix = "" if kind == "harvey4" else f"[{kind}]"
        rows = {f"colpass{suffix}": 0, f"fused_fourstep{suffix}": 1,
                "pointwise32": 2}
    expect = {(k if k.startswith("fused_") else f"fold_{k}"): v
              for k, v in expect.items()}
    checks["launches"] = all(expect[k] == v for k, v in launches.items())
    ok = all(checks.values())
    passes = plans["fold"].passes
    n1, n2 = passes["cp1"].nn, passes["cp2"].nn  # the internal split
    splits = {"fold": [n1, n2]}
    if "fused" in plans:
        splits["fused"] = list(plans["fused"].passes["ff"].shape_in)
    emit({"phase": "flat", "flat": phase, "field": name, "p": p, "n": n,
          "inner_split": splits, "batch": B, "reduction": kind,
          "negacyclic_n": nn_ if nega else None, "oracle": "native",
          "gate_rows": gate_rows.tolist(), "checks": checks,
          "launches": launches, "ok": ok})
    if not ok:
        fail("flat", f"{phase} {name} n = 2^{log_n}: the flat plans "
             "disagree with their oracles or did not launch as expected")
        return None

    # timing: us per NTT of each callable, the gather alone, the internal
    # four-step transform alone, and the plain flat stage loops
    us = {}
    for k in kinds:
        bat = plans[k].make_batched(B)
        us[k] = {"fwd": time_device(bat["fwd"], x)["us_per_iter"] / B,
                 "inv": time_device(bat["inv"], x)["us_per_iter"] / B,
                 "polymul": time_device(lambda v: bat["polymul"](v, v),
                                        x)["us_per_iter"] / B}
        if nega:
            nb = nega[k].make_batched(B)
            us[k]["negacyclic_polymul"] = time_device(
                lambda v: nb["negacyclic_polymul"](v, v),
                xa)["us_per_iter"] / B
    g = torch.from_numpy(tw.flat_gather(n1, n2)).to(dev)
    gather_us = time_device(lambda v: take(v, g), x)["us_per_iter"] / B

    def fourstep(v):  # the fold plan's internal transform alone
        out = passes["cp2"](passes["cp1"](v))
        return (tuple(t.reshape(B, n1, n2) for t in out) if gl
                else out.reshape(B, n1, n2))

    xm = tuple(t.reshape(B, n1, n2) for t in x) if gl \
        else x.reshape(B, n1, n2)
    fourstep_us = time_device(fourstep, xm)["us_per_iter"] / B
    plain_us = time_device(fs.fwd, head(x, pb), iters=2,
                           repeats=3)["us_per_iter"] / pb
    line = {"phase": "flat_time", "flat": phase, "field": name, "n": n,
            "inner_split": splits, "batch": B, "reduction": kind,
            "card": card, "us_per_ntt": us,
            "gather_us_per_ntt": gather_us,
            "gather_share_of_fold_fwd": gather_us / us["fold"]["fwd"],
            "fourstep_fold_fwd_us_per_ntt": fourstep_us,
            "plain_stages_fwd_us_per_ntt": plain_us, "plain_batch": pb,
            "method": "CUDA events; 5 repeats of a dependent chain of 10 "
                      "(plain: 3 of 2), trimmed mean; us per NTT = us per "
                      "call / batch; polymul of x with itself"}
    emit(line)
    return {row: sum(v[i] for v in launches.values())
            for row, i in rows.items()}, line


def flat_route_a(spec, dev, card, gen):
    """Phase 21, one configuration of FLAT_ROUTE_A: route (a) of the flat
    forward (one column pass over (1, n, B), the batch as columns, after
    one torch transpose, then the colperm -> bit-reversal gather where
    the column nests), held equal to the plain flat forward and to the
    plan's route (b), and timed beside it. Returns False after emitting
    the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import stages as S
    from ntt_aie_tpu_torch.utils.timing import time_device

    name, log_n, B = spec
    field = T.FIELDS[name]
    n = 1 << log_n
    cfg = T.NTTConfig(field=field, log_n=log_n)
    kind = cfg.resolved_reduction
    cp = C.make_colpass(field, n, direction="dif", canonicalize=True,
                        transpose_out=True, reduction=kind, device=dev)
    order = tw.colperm(n)[tw.bit_reverse_indices(n)]
    perm = (None if np.array_equal(order, np.arange(n))
            else torch.from_numpy(order).to(dev))

    def route_a(v):
        out = C.colpass(v.t().contiguous().unsqueeze(0), cp)[0]
        return out if perm is None else out.index_select(1, perm)

    x = torch.randint(0, field.p, (B, n), dtype=torch.int32, device=dev,
                      generator=gen)
    fold = T.build_plan(cfg, device=dev).make_batched(B)
    fused = T.build_plan(cfg, device=dev, fused=True).make_batched(B)
    ya = route_a(x)
    fs = S.make_flat_stages(field, n, reduction=kind, device=dev)
    pb = FLAT_PLAIN_BATCH
    ok = bool(torch.equal(ya, fold["fwd"](x))
              and torch.equal(ya[:pb], fs.fwd(x[:pb])))
    del ya
    xc = x.t().contiguous().unsqueeze(0)
    us = {"route_a": time_device(route_a, x)["us_per_iter"] / B,
          "route_a_transpose": time_device(
              lambda v: v.t().contiguous().view(B, n), x)["us_per_iter"] / B,
          "route_a_colpass": time_device(
              lambda v: C.colpass(v, cp).view(1, n, B), xc)["us_per_iter"]
          / B,
          "route_b_fold": time_device(fold["fwd"], x)["us_per_iter"] / B,
          "route_b_fused": time_device(fused["fwd"], x)["us_per_iter"] / B}
    if perm is not None:
        us["route_a_gather"] = time_device(
            lambda v: v.index_select(1, perm), x)["us_per_iter"] / B
    emit({"phase": "flat_route_a", "field": name, "n": n, "batch": B,
          "reduction": kind, "card": card,
          "column": "nested" if cp.wmid is not None else "plain",
          "equals_route_b_and_plain": ok, "us_per_ntt": us,
          "method": "CUDA events; 5 repeats of a dependent chain of 10, "
                    "trimmed mean; us per NTT = us per call / batch"})
    if not ok:
        fail("flat_route_a", f"route (a) of the flat forward over {name} "
             f"n = 2^{log_n} differs from the plain flat forward or the "
             "plan's")
    return ok


def flat_phases(args, dev, card, rng):
    """Phases 20-22: the flat split F1-F5, route (a), and the Goldilocks
    negacyclic product at n = 2^20. Returns phases 20 and 22's launches
    by kernel row, or None after emitting the failure."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    launches = {}
    for spec in FLAT_PLANS:
        got = flat_phase(spec, dev, card, gen, rng)
        if got is None:
            return None
        for row, count in got[0].items():
            launches[row] = launches.get(row, 0) + count
        torch.cuda.empty_cache()
    got = flat_n2_phase(dev, gen, rng)
    if got is None:
        return None
    for row, count in got.items():
        launches[row] = launches.get(row, 0) + count
    for spec in FLAT_ROUTE_A:
        if not flat_route_a(spec, dev, card, gen):
            return None
        torch.cuda.empty_cache()
    got = gl_negacyclic_phase(dev, card, gen, rng)
    if got is None:
        return None
    for row, count in got.items():
        launches[row] = launches.get(row, 0) + count
    torch.cuda.empty_cache()
    return launches


def gl_negacyclic_phase(dev, card, gen, rng):
    """Phase 22: the Goldilocks negacyclic product on the four-step split
    at n = 2^GL_LOG_N, B = GL_BATCH: the device memory its plan and its
    batched callables hold beyond the cyclic plan's (psi and psi^-1, held
    once and broadcast over the batch: at most 16 MiB at n = 2^20), gated
    on the native oracle, its launches counted, and timed beside the
    cyclic product. Returns {kernel row: launches}, or None after emitting
    the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    field = T.GOLDILOCKS
    p, B = field.p, GL_BATCH
    cfg = T.NTTConfig(field=field, log_n=GL_LOG_N, rows_log2=GL_LOG_N // 2,
                      negacyclic=True)
    n = cfg.n

    def held_by(c):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        plan = T.build_plan(c, device=dev)
        bat = plan.make_batched(B)
        torch.cuda.synchronize()
        return plan, bat, torch.cuda.memory_allocated(dev) - before

    cyclic = held_by(T.NTTConfig(field=field, log_n=GL_LOG_N,
                                 rows_log2=GL_LOG_N // 2))[2]
    plan, bat, held = held_by(cfg)
    held -= cyclic
    v = rng.integers(0, 1 << 64, (2, B, n), dtype=np.uint64) % np.uint64(p)
    a, b = (M.gl_from_u64(u, dev) for u in v)
    G.gl_colpass.launches = G.gl_mul.launches = 0
    d = bat["negacyclic_polymul"](a, b)
    torch.cuda.synchronize()
    launches = [G.gl_colpass.launches, G.gl_mul.launches]
    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=2, replace=False)])
    psi = field.root_of_unity(2 * n)
    got = M.gl_to_u64(*(t[torch.from_numpy(gate_rows).to(dev)] for t in d))
    gate_ok = all(np.array_equal(
        r, native_oracle.negacyclic_polymul(v[0, i], v[1, i], psi, p))
        for r, i in zip(got, gate_rows))
    del d
    counts_ok = launches == [6, 4]
    psi_ok = held <= 16 << 20
    ok = bool(gate_ok and counts_ok and psi_ok)
    emit({"phase": "gl_negacyclic", "n": n, "split": list(cfg.split),
          "batch": B, "oracle": "native", "gate_rows": gate_rows.tolist(),
          "gate_ok": bool(gate_ok), "launches": launches,
          "launches_ok": counts_ok, "psi_tables_bytes": held,
          "psi_tables_ok": psi_ok, "ok": ok})
    if not ok:
        fail("gl_negacyclic", "the Goldilocks negacyclic product at n = "
             f"2^{GL_LOG_N} disagrees with the native oracle, did not "
             "launch 6 column passes and 4 products, or holds more than "
             "16 MiB of psi tables")
        return None
    us = {k: time_device(lambda t: bat[k](t, t), a)["us_per_iter"] / B
          for k in ("polymul", "negacyclic_polymul")}
    emit({"phase": "gl_negacyclic_time", "n": n, "batch": B, "card": card,
          "us_per_ntt": us,
          "method": "CUDA events; 5 repeats of a dependent chain of 10, "
                    "trimmed mean; us per NTT = us per call / batch; "
                    "product of x with itself"})
    return {"gl_colpass": launches[0], "gl_mul": launches[1]}


def prepost_kernel_phase(args, dev):
    """Phase 23: the column kernel's instantiations with 'pre' and 'post'
    operands (PREPOST_PASSES) against the plain version, raw and bit-exact,
    under all four reductions at PREPOST_KERNEL_SHAPES, B = 1 and 4.
    Returns {instantiation: largest error}, or None after emitting the
    failure."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.plan import fold_passes

    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    errs = {}
    for kind, name, shapes in PREPOST_KERNEL_SHAPES:
        field = T.FIELDS[name]
        top = _domain_top(kind, field.p)
        for n1, n2 in shapes:
            for kw, pname in PREPOST_PASSES:
                cp = fold_passes(field, n1, n2, reduction=kind, device=dev,
                                 **kw)[pname]
                key = C.variant(cp)
                rows, cols = (n2, n1) if pname == "cp2" else (n1, n2)
                for B in (1, 4):
                    x = torch.randint(0, top, (B, rows, cols),
                                      dtype=torch.int64, device=dev,
                                      generator=gen).to(torch.int32)
                    got = C.colpass(x, cp)
                    torch.cuda.synchronize()
                    want = C.colpass_plain(x, cp)
                    err = int((got.long() - want.long()).abs().max())
                    errs[key] = max(errs.get(key, 0), err)
                    if err or not torch.equal(got, want):
                        emit({"phase": "prepost_kernel", "reduction": kind,
                              "pass": pname, "variant": key,
                              "shape": [B, rows, cols], "max_abs_err": err})
                        fail("prepost_kernel", f"{kind} {pname} ({key}) "
                             f"{[B, rows, cols]} differs from its plain "
                             "version")
                        return None
        emit({"phase": "prepost_kernel", "reduction": kind,
              "shapes": [list(s) for s in shapes],
              "passes": [f"{pname}{'' if kw.get('wmat_fold', True) else '[entry]'}"
                         for kw, pname in PREPOST_PASSES],
              "batches": [1, 4], "equal": True, "max_abs_err": 0})
    # the factored and rank-1 instantiations, over the passes' own rows
    for kind, name, splits in WFAC_KERNEL_SHAPES:
        field = T.FIELDS[name]
        top = _domain_top(kind, field.p)
        seen = []
        for n1, n2 in splits:
            for kw, pname in WFAC_PASSES:
                rows, cols = ((n2, n1) if pname in ("cp2", "icp2")
                              else (n1, n2))
                if rows == 64 and cols == 8192:
                    continue  # the 8,192-row column runs on the other split
                cp = fold_passes(field, n1, n2, reduction=kind, device=dev,
                                 **kw)[pname]
                key = C.variant(cp)
                for B in (1, 4):
                    x = torch.randint(0, top, (B, rows, cols),
                                      dtype=torch.int64, device=dev,
                                      generator=gen).to(torch.int32)
                    got = C.colpass(x, cp)
                    torch.cuda.synchronize()
                    want = C.colpass_plain(x, cp)
                    err = int((got.long() - want.long()).abs().max())
                    errs[key] = max(errs.get(key, 0), err)
                    if err or not torch.equal(got, want):
                        fail("prepost_kernel", f"{kind} factored {pname} "
                             f"({key}) {[B, rows, cols]} differs from its "
                             "plain version")
                        return None
                seen.append([key, [rows, cols]])
        emit({"phase": "prepost_kernel", "reduction": kind,
              "arm": "wmat_factored",
              "variants": sorted({v for v, _ in seen}),
              "shapes": seen, "batches": [1, 4], "equal": True,
              "max_abs_err": 0})
    gl_errs = gl_arm_kernel_phase(dev, gen)
    if gl_errs is None:
        return None
    errs.update(gl_errs)
    return errs


def gl_arm_kernel_phase(dev, gen):
    """Phase 23, Goldilocks: the kernel's 'pre' matrix and 'wfac'
    instantiations (GL_ARM_PASSES) against the plain version, both limb
    planes bit-exact, at GL_ARM_KERNEL_SHAPES (the passes over 8,192 rows
    only, on the splits with one side of 8,192), B = 1 and 4. Returns
    {'gl:' + instantiation: largest error}, or None after emitting the
    failure."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M

    field = T.GOLDILOCKS
    errs, seen = {}, []
    for n1, n2 in GL_ARM_KERNEL_SHAPES:
        for kw, pname in GL_ARM_PASSES:
            rows, cols = (n2, n1) if pname in ("cp2", "icp2") else (n1, n2)
            if rows == 64 and cols == 8192:
                continue
            cp = gl_fold_passes(field, n1, n2, device=dev, **kw)[pname]
            key = "gl:" + G.variant(cp)
            for B in (1, 4):
                hi, lo = (M.from_carrier(torch.randint(
                    0, 1 << 32, (B, rows, cols), dtype=torch.int64,
                    device=dev, generator=gen)) for _ in range(2))
                x = (hi, torch.where(hi == -1, torch.zeros_like(lo), lo))
                got = G.gl_colpass(x, cp)
                torch.cuda.synchronize()
                want = G.gl_colpass_plain(x, cp)
                err = max(int((g.long() - w.long()).abs().max())
                          for g, w in zip(got, want))
                errs[key] = max(errs.get(key, 0), err)
                if err:
                    fail("prepost_kernel", f"Goldilocks {pname} ({key}) "
                         f"{[B, rows, cols]} differs from its plain version")
                    return None
            seen.append([key, [rows, cols]])
    emit({"phase": "prepost_kernel", "reduction": "goldilocks",
          "arm": "wmat_fold=False, wmat_factored",
          "variants": sorted(errs), "shapes": seen, "batches": [1, 4],
          "equal": True, "max_abs_err": 0})
    return errs


def _gate_negacyclic(d, a, b, rows, field, dev):
    """Rows of the (B, n1, n2) product d against the native negacyclic
    product of the same rows of a and b."""
    import numpy as np
    import torch

    from ntt_aie_tpu_torch import native_oracle

    n = a.shape[1] * a.shape[2]
    idx = torch.from_numpy(rows).to(dev)
    got = d[idx].reshape(len(rows), n).cpu().numpy().astype(np.uint64)
    ra = a[idx].reshape(len(rows), n).cpu().numpy()
    rb = b[idx].reshape(len(rows), n).cpu().numpy()
    psi = field.root_of_unity(2 * n)
    return all(np.array_equal(
        got[i], native_oracle.negacyclic_polymul(ra[i], rb[i], psi,
                                                 field.p).astype(np.uint64))
        for i in range(len(rows)))


def nega_fold_phase(args, dev, card, rng):
    """Phase 24: the negacyclic product on the four-step fold plan
    (NEGA_PLANS), gated on the native oracle on row 0 and 8 random rows,
    its launches counted (6 column passes, 0 fused launches; the
    instantiations by colpass.launches_by), equal to the wmat_fold=False
    plan's; timed beside the cyclic product and the fused plan's
    negacyclic product; the harvey4 plan's ncp1 and nicp1 timed alone
    beside cp1 and icp1, and their plain versions at a batch of 4.
    Returns (launches by instantiation, timing line), or None after
    emitting the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import pointwise as PW
    from ntt_aie_tpu_torch.utils.timing import time_device

    gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
    main_launches, timing = None, None
    for name, log_n, rows_log2, B in NEGA_PLANS:
        field = T.FIELDS[name]
        cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2,
                          negacyclic=True)
        n1, n2 = cfg.split
        plan = T.build_plan(cfg, device=dev)
        bat = plan.make_batched(B)
        a, b = (torch.randint(0, field.p, (B, n1, n2), dtype=torch.int32,
                              device=dev, generator=gen) for _ in range(2))
        C.colpass.launches = F.fused_fourstep.launches = 0
        C.colpass.launches_by = {}
        PW.mul32.launches = 0
        d = bat["negacyclic_polymul_mat"](a, b)
        torch.cuda.synchronize()
        launches = [C.colpass.launches, F.fused_fourstep.launches,
                    PW.mul32.launches]
        by = dict(C.colpass.launches_by)
        gate_rows = np.concatenate(
            [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
        gate_ok = _gate_negacyclic(d, a, b, gate_rows, field, dev)
        entry = T.build_plan(cfg, device=dev, wmat_fold=False)
        entry_ok = bool(torch.equal(
            entry.make_batched(B)["negacyclic_polymul_mat"](a, b), d))
        del d
        counts_ok = launches == [6, 0, 1] and by == {
            "dif+pre+post_t+T": 2, "dif": 2, "dit+post_t+T": 1,
            "dit+post": 1}
        ok = bool(gate_ok and entry_ok and counts_ok)
        emit({"phase": "nega_fold", "field": name, "p": field.p,
              "n": cfg.n, "split": [n1, n2], "batch": B,
              "reduction": plan.reduction, "oracle": "native",
              "gate_rows": gate_rows.tolist(), "gate_ok": bool(gate_ok),
              "entry_equals_fold": entry_ok, "launches": launches,
              "launches_by": by, "launches_ok": counts_ok, "ok": ok})
        if not ok:
            fail("nega_fold", f"the fold plan's negacyclic product over "
                 f"{name} disagrees with the native oracle or the entry "
                 "arm, or did not launch 6 column passes and 1 product")
            return None
        if main_launches is None:
            main_launches = by
            fused = T.build_plan(cfg, device=dev, fused=True)
            fb = fused.make_batched(B)
            fused_ok = bool(torch.equal(fb["negacyclic_polymul_mat"](a, b),
                                        bat["negacyclic_polymul_mat"](a, b)))
            us = {k: time_device(lambda t, f=f: f(t, t), a)["us_per_iter"]
                  / B for k, f in (
                      ("fold_polymul_mat", bat["polymul_mat"]),
                      ("fold_negacyclic_polymul_mat",
                       bat["negacyclic_polymul_mat"]),
                      ("fused_negacyclic_polymul_mat",
                       fb["negacyclic_polymul_mat"]))}
            del fused, fb
            passes = plan.passes
            pass_us = {k: time_device(passes[k], a)["us_per_iter"]
                       for k in ("cp1", "ncp1", "icp1", "nicp1")}
            xp = a[:4]
            plain_us = {k: time_device(
                lambda t, cp=passes[k]: C.colpass_plain(t, cp), xp,
                iters=2, repeats=3)["us_per_iter"] for k in ("ncp1", "nicp1")}
            info = {k: C.kernel_info(passes[k], n2)
                    for k in ("cp1", "ncp1", "icp1", "nicp1")}
            timing = {"phase": "nega_fold_time", "field": name, "n": cfg.n,
                      "batch": B, "card": card,
                      "fused_equals_fold": fused_ok,
                      "us_per_ntt": us,
                      "pass_us_per_call": pass_us, "plain_batch": 4,
                      "plain_us_per_call": plain_us, "kernel_info": info,
                      "method": "CUDA events; kernel: 5 repeats of a "
                                "dependent chain of 10, plain: 3 repeats "
                                "of 2; trimmed mean; us per NTT = us per "
                                "call / batch; products of x with itself"}
            emit(timing)
            if not fused_ok:
                fail("nega_fold", "the fold plan's negacyclic product "
                     "differs from the fused plan's")
                return None
        del plan, bat, entry, a, b
        torch.cuda.empty_cache()
    return main_launches, timing


def wmat_entry_phase(args, dev, card):
    """Phase 25: the wmat_fold=False plan (the four-step multiply at the
    second pass's entry, 'pre') at n = 2^20, B = 256 over p = 469762049,
    equal to the fold plan on every callable; fwd_mat and inv_mat of both
    timed in turns (fold, entry, entry, fold), the products once each,
    and cp2, icp1, ncp1 and nicp1 of the entry arm alone, with their plain
    versions at a batch of 4. Returns (launches by instantiation, timing
    line), or None after emitting the failure."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.utils.timing import time_device

    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    field, B = T.P_469762049, 256
    cfg = T.NTTConfig(field=field, log_n=20, negacyclic=True)
    n, (n1, n2) = cfg.n, cfg.split
    fold = T.build_plan(cfg, device=dev).make_batched(B)
    entry_plan = T.build_plan(cfg, device=dev, wmat_fold=False)
    entry = entry_plan.make_batched(B)
    x, y = (torch.randint(0, field.p, (B, n1, n2), dtype=torch.int32,
                          device=dev, generator=gen) for _ in range(2))
    per, equal = _by_callable((entry, fold), _operands_of(x, y, n),
                              (C.colpass,))
    by = _summed(per)
    ok = all(equal.values())
    emit({"phase": "wmat_entry", "n": n, "split": [n1, n2], "batch": B,
          "equal_to_fold": equal, "launches_by": by, "ok": ok})
    if not ok:
        fail("wmat_entry", "the wmat_fold=False plan differs from the fold "
             "plan")
        return None
    turns = {}
    for key in ("fwd_mat", "inv_mat"):
        f_us, e_us = _turns((fold[key], entry[key]), x)
        turns[key] = {"fold_us_per_ntt": f_us / B, "entry_us_per_ntt": e_us / B,
                      "entry_over_fold": e_us / f_us}
    for key in ("polymul_mat", "negacyclic_polymul_mat"):
        turns[key] = {"entry_us_per_ntt": time_device(
            lambda t, f=entry[key]: f(t, t), x)["us_per_iter"] / B}
    passes = entry_plan.passes
    pass_us = {k: time_device(passes[k], x)["us_per_iter"]
               for k in ("cp2", "icp1", "ncp1", "nicp1")}
    plain_us = {k: time_device(lambda t, cp=passes[k]: C.colpass_plain(t, cp),
                               x[:4], iters=2, repeats=3)["us_per_iter"]
                for k in ("cp2", "icp1", "ncp1", "nicp1")}
    info = {k: C.kernel_info(passes[k], n1 if k == "cp2" else n2)
            for k in ("cp2", "icp1", "ncp1", "nicp1")}
    timing = {"phase": "wmat_entry_time", "n": n, "batch": B, "card": card,
              "us": turns, "pass_us_per_call": pass_us, "plain_batch": 4,
              "plain_us_per_call": plain_us, "kernel_info": info,
              "method": "CUDA events; 5 repeats of a dependent chain of 10, "
                        "trimmed mean; fwd_mat/inv_mat in turns fold, "
                        "entry, entry, fold, the mean of two readings; "
                        "products of x with itself; plain: 3 repeats of 2"}
    emit(timing)
    return by, timing


def _gate_fwd(y, x, rows, field, spectral_to_natural, dev):
    """Rows of the (B, .., ..) forward y of x (32-bit int32 tensors or
    Goldilocks limb pairs) against the native oracle's DIF of the same
    rows of x, in natural order."""
    import numpy as np
    import torch

    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.ops import modops as M

    idx = torch.from_numpy(rows).to(dev)
    if isinstance(y, tuple):
        B, n = y[0].shape[0], y[0][0].numel()
        got = M.gl_to_u64(*(v.reshape(B, n)[idx] for v in y))
        rows_in = M.gl_to_u64(*(v.reshape(B, n)[idx] for v in x))
    else:
        B, n = y.shape[0], y[0].numel()
        got = y.reshape(B, n)[idx].cpu().numpy().view(np.uint32)
        rows_in = x.reshape(B, n)[idx].cpu().numpy().astype(np.uint64)
    want = native_oracle.ntt_dif_batch(
        rows_in, field.root_of_unity(n), field.p)[:, tw.bit_reverse_indices(n)]
    return bool(np.array_equal(
        got[:, spectral_to_natural].astype(np.uint64),
        want.astype(np.uint64)))


def _by_callable(bats, operands, counters):
    """Drive each callable of bats[0] on its operands once: its launches
    by instantiation (counters: the kernel wrappers, whose launches_by is
    reset just before each call and read just after), and whether its
    output equals that of the same callable of every other dict in bats."""
    import torch

    by, equal = {}, {}
    for key, ops in operands.items():
        for c in counters:
            c.launches_by = {}
        got = bats[0][key](*ops)
        torch.cuda.synchronize()
        by[key] = {k: v for c in counters for k, v in c.launches_by.items()}
        same = True
        for other in bats[1:]:
            want = other[key](*ops)
            if isinstance(got, tuple):
                same = same and all(torch.equal(u, v)
                                    for u, v in zip(got, want))
            else:
                same = same and bool(torch.equal(got, want))
            del want
        equal[key] = same
        del got
    return by, equal


def _operands_of(x, y, n):
    """The eight callables' operands from two (B, n1, n2) batches (or
    Goldilocks limb pairs): inv_mat takes x read as a (B, n2, n1)
    spectrum."""
    def shaped(v, *shape):
        return (tuple(t.reshape(t.shape[0], *shape) for t in v)
                if isinstance(v, tuple) else v.reshape(v.shape[0], *shape))

    first = x[0] if isinstance(x, tuple) else x
    spec = shaped(x, first.shape[2], first.shape[1])
    flat_x, flat_y = shaped(x, n), shaped(y, n)
    return {"fwd_mat": (x,), "inv_mat": (spec,), "polymul_mat": (x, y),
            "negacyclic_polymul_mat": (x, y), "fwd": (flat_x,),
            "inv": (flat_x,), "polymul": (flat_x, flat_y),
            "negacyclic_polymul": (flat_x, flat_y)}


def _summed(per, prefix=""):
    """The launches by instantiation of _by_callable summed over the
    callables, each key prefixed."""
    total = {}
    for d in per.values():
        for k, v in d.items():
            total[prefix + k] = total.get(prefix + k, 0) + v
    return total


def wfac_phase(args, dev, card, rng):
    """Phase 27: the wmat_factored=True plan at n = 2^20, B = 256 over
    p = 469762049 (negacyclic): every callable equal to the fold plan's,
    fwd_mat gated on the native oracle, launches by instantiation
    (2 / 2 / 6 / 6); fwd_mat and inv_mat timed in turns with the fold and
    the entry arm (fold, factored, entry, entry, factored, fold), the
    products once each, and cp2, icp2, ncp1 and nicp1 alone with
    kernel_info and their plain versions at a batch of 4; then the
    montgomery and barrett plans of FAC_CHECKS equal to their fold plans.
    Returns (launches by instantiation, timing line), or None after
    emitting the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.utils.timing import time_device

    gen = torch.Generator(device=dev).manual_seed(args.seed + 10)
    field, B = T.P_469762049, 256
    cfg = T.NTTConfig(field=field, log_n=20, negacyclic=True)
    n, (n1, n2) = cfg.n, cfg.split
    fold_plan = T.build_plan(cfg, device=dev)
    fold = fold_plan.make_batched(B)
    fac_plan = T.build_plan(cfg, device=dev, wmat_factored=True)
    fac = fac_plan.make_batched(B)
    x, y = (torch.randint(0, field.p, (B, n1, n2), dtype=torch.int32,
                          device=dev, generator=gen) for _ in range(2))
    by, equal = _by_callable((fac, fold), _operands_of(x, y, n), (C.colpass,))
    gate_rows = np.concatenate(
        [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
    gate_ok = _gate_fwd(fac["fwd_mat"](x), x, gate_rows, field,
                        fac_plan.spectral_to_natural, dev)
    want_by = {
        "fwd_mat": {"dif+T": 1, "dif+wfac_pre": 1},
        "inv_mat": {"dit+wfac_post+T": 1, "dit": 1},
        "polymul_mat": {"dif+T": 2, "dif+wfac_pre": 2, "dit+wfac_post+T": 1,
                        "dit": 1},
        "negacyclic_polymul_mat": {"dif+rank1_pre+T": 2, "dif+wfac_pre": 2,
                                   "dit+wfac_post+T": 1, "dit+rank1_post": 1}}
    counts_ok = all(by[k] == v for k, v in want_by.items())
    total = _summed(by)
    ok = bool(all(equal.values()) and gate_ok and counts_ok
              and fac_plan.wmat_factored and not fac_plan.wmat_fold)
    emit({"phase": "wmat_factored", "n": n, "split": [n1, n2], "batch": B,
          "reduction": fac_plan.reduction, "equal_to_fold": equal,
          "oracle": "native", "gate_rows": gate_rows.tolist(),
          "gate_ok": gate_ok, "launches_by": by, "launches_ok": counts_ok,
          "ok": ok})
    if not ok:
        fail("wmat_factored", "the wmat_factored=True plan differs from the "
             "fold plan or the native oracle, or launched other kernels")
        return None
    entry = T.build_plan(cfg, device=dev, wmat_fold=False).make_batched(B)
    us = {}
    for key in ("fwd_mat", "inv_mat"):
        f_us, w_us, e_us = _turns((fold[key], fac[key], entry[key]), x)
        us[key] = {"fold_us_per_ntt": f_us / B,
                   "factored_us_per_ntt": w_us / B,
                   "entry_us_per_ntt": e_us / B,
                   "factored_over_fold": w_us / f_us,
                   "factored_over_entry": w_us / e_us}
    for key in ("polymul_mat", "negacyclic_polymul_mat"):
        us[key] = {"factored_us_per_ntt": time_device(
            lambda t, f=fac[key]: f(t, t), x)["us_per_iter"] / B}
    del entry
    # each pass alone on x: n1 == n2, so every pass takes (B, n1, n2)
    passes = fac_plan.passes
    names = ("cp2", "icp2", "ncp1", "nicp1")
    pass_us = {k: time_device(passes[k], x)["us_per_iter"] for k in names}
    plain_us = {k: time_device(lambda t, cp=passes[k]: C.colpass_plain(t, cp),
                               x[:4], iters=2, repeats=3)["us_per_iter"]
                for k in names}
    info = {k: C.kernel_info(passes[k], n2) for k in names}
    timing = {"phase": "wmat_factored_time", "n": n, "batch": B,
              "card": card, "us": us, "pass_us_per_call": pass_us,
              "plain_batch": 4, "plain_us_per_call": plain_us,
              "kernel_info": info,
              "method": "CUDA events; 5 repeats of a dependent chain of 10, "
                        "trimmed mean; fwd_mat/inv_mat in turns fold, "
                        "factored, entry, entry, factored, fold, the mean of "
                        "two readings; products of x with itself; plain: 3 "
                        "repeats of 2"}
    emit(timing)
    del fold, fac, fold_plan, x, y
    torch.cuda.empty_cache()
    for kind, name, log_n, rows_log2, Bc, nega in FAC_CHECKS:
        f = T.FIELDS[name]
        c = T.NTTConfig(field=f, log_n=log_n, rows_log2=rows_log2,
                        negacyclic=nega)
        m1, m2 = c.split
        plan = T.build_plan(c, device=dev, wmat_factored=True)
        a, b = (torch.randint(0, f.p, (Bc, m1, m2), dtype=torch.int32,
                              device=dev, generator=gen) for _ in range(2))
        ops = _operands_of(a, b, c.n)
        if not nega:
            ops = {k: v for k, v in ops.items() if "negacyclic" not in k}
        cby, ceq = _by_callable(
            (plan.make_batched(Bc), T.build_plan(c, device=dev)
             .make_batched(Bc)), ops, (C.colpass,))
        cok = all(ceq.values()) and plan.reduction == kind
        emit({"phase": "wmat_factored", "reduction": plan.reduction,
              "field": name, "n": c.n, "split": [m1, m2], "batch": Bc,
              "equal_to_fold": ceq, "launches_by": cby, "ok": cok})
        if not cok:
            fail("wmat_factored", f"the {kind} wmat_factored=True plan "
                 "differs from its fold plan")
            return None
        del plan, a, b, ops
        torch.cuda.empty_cache()
    return total, timing


def gl_arms_phase(args, dev, card, rng):
    """Phase 28: the Goldilocks wmat_fold=False and wmat_factored=True
    plans at n = 2^20, B = 64 (negacyclic): every callable equal to the
    fold plan's, fwd_mat gated on the native oracle, launches by
    instantiation; fwd_mat timed in turns among the three arms (fold,
    entry, factored, factored, entry, fold), and the new passes alone with
    kernel_info and their plain versions at a batch of 4. Returns
    (launches by instantiation, timing line), or None after emitting the
    failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    field, B = T.GOLDILOCKS, GL_BATCH
    cfg = T.NTTConfig(field=field, log_n=GL_LOG_N, rows_log2=GL_LOG_N // 2,
                      negacyclic=True)
    n, (n1, n2) = cfg.n, cfg.split
    v = rng.integers(0, 1 << 64, (2, B, n1, n2), dtype=np.uint64) \
        % np.uint64(field.p)
    x, y = (M.gl_from_u64(u, dev) for u in v)
    fold = T.build_plan(cfg, device=dev).make_batched(B)
    plans, bats, total = {}, {}, {}
    for arm, kw in (("entry", {"wmat_fold": False}),
                    ("factored", {"wmat_factored": True})):
        plans[arm] = T.build_plan(cfg, device=dev, **kw)
        bats[arm] = plans[arm].make_batched(B)
        by, equal = _by_callable((bats[arm], fold), _operands_of(x, y, n),
                                 (G.gl_colpass,))
        gate_rows = np.concatenate(
            [[0], rng.choice(np.arange(1, B), size=8, replace=False)])
        gate_ok = _gate_fwd(bats[arm]["fwd_mat"](x), x, gate_rows, field,
                            plans[arm].spectral_to_natural, dev)
        fwd_by = ({"dif+T": 1, "dif+pre": 1} if arm == "entry"
                  else {"dif+T": 1, "dif+wfac_pre": 1})
        inv_by = ({"dit+T": 1, "dit+pre": 1} if arm == "entry"
                  else {"dit+wfac_post+T": 1, "dit": 1})
        counts_ok = by["fwd_mat"] == fwd_by and by["inv_mat"] == inv_by
        total.update(_summed(by, f"{arm}:"))
        ok = bool(all(equal.values()) and gate_ok and counts_ok
                  and plans[arm].wmat_factored == (arm == "factored")
                  and not plans[arm].wmat_fold)
        emit({"phase": "gl_arms", "arm": arm, "n": n, "split": [n1, n2],
              "batch": B, "equal_to_fold": equal, "oracle": "native",
              "gate_rows": gate_rows.tolist(), "gate_ok": gate_ok,
              "launches_by": by, "launches_ok": counts_ok, "ok": ok})
        if not ok:
            fail("gl_arms", f"the Goldilocks {arm} arm differs from the fold "
                 "plan or the native oracle, or launched other kernels")
            return None
    f_us, e_us, w_us = _turns(
        (fold["fwd_mat"], bats["entry"]["fwd_mat"],
         bats["factored"]["fwd_mat"]), x)
    us = {"fwd_mat": {"fold_us_per_ntt": f_us / B,
                      "entry_us_per_ntt": e_us / B,
                      "factored_us_per_ntt": w_us / B,
                      "entry_over_fold": e_us / f_us,
                      "factored_over_fold": w_us / f_us}}
    # each pass alone on x: n1 == n2, so every pass takes (B, n1, n2)
    cases = {f"{arm}:{k}": plans[arm].passes[k]
             for arm, k in (("entry", "cp2"), ("entry", "icp1"),
                            ("factored", "cp2"), ("factored", "icp2"))}
    pass_us = {k: time_device(cp, x)["us_per_iter"]
               for k, cp in cases.items()}
    plain_us = {k: time_device(lambda u, cp=cp: G.gl_colpass_plain(u, cp),
                               tuple(w[:4] for w in x), iters=2,
                               repeats=3)["us_per_iter"]
                for k, cp in cases.items()}
    info = {k: G.kernel_info(cp, n2) for k, cp in cases.items()}
    timing = {"phase": "gl_arms_time", "n": n, "batch": B, "card": card,
              "us": us, "pass_us_per_call": pass_us, "plain_batch": 4,
              "plain_us_per_call": plain_us, "kernel_info": info,
              "method": "CUDA events; 5 repeats of a dependent chain of 10, "
                        "trimmed mean; fwd_mat in turns fold, entry, "
                        "factored, factored, entry, fold, the mean of two "
                        "readings; plain: 3 repeats of 2"}
    emit(timing)
    return total, timing


def rns_phase(args, dev, card, rng):
    """Phase 26: RNSPolymul on the card (RNS_CASES): the residue products
    against the native oracle on row 0 and 2 random rows, the device limbs
    against the host's object-math CRT of the same residues on those rows
    and against the plain combine on every coefficient, and launches; the
    exactness of RNSPolymul(RNS_EXACT_LOG_N) against the schoolbook integer
    product; timings of polymul_limbs (host to limbs), of its device part
    and of the combine alone. Returns the crt row's numbers, or None after
    emitting the failure."""
    import math
    import time

    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import crt
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import pointwise as PW
    from ntt_aie_tpu_torch.utils.timing import time_device

    row = None
    max_err = 0
    for log_n, negacyclic, B in RNS_CASES:
        rns = T.RNSPolymul(log_n, negacyclic=negacyclic, device=dev)
        n, bound = rns.n, rns.max_input_bound()
        a, b = (rng.integers(-bound, bound + 1, (B, n)) for _ in range(2))
        ra, rb = rns._residues(a), rns._residues(b)
        C.colpass.launches = F.fused_fourstep.launches = 0
        crt.crt_combine.launches = PW.mul32.launches = 0
        pending, mat = rns._residue_products(a, b)
        limbs = rns._combine(*pending)
        torch.cuda.synchronize()
        launches = {"colpass": C.colpass.launches,
                    "fused_fourstep": F.fused_fourstep.launches,
                    "crt": crt.crt_combine.launches,
                    "pointwise32": PW.mul32.launches}
        rows = np.concatenate(
            [[0], rng.choice(np.arange(1, B), size=2, replace=False)])
        idx = torch.from_numpy(rows).to(dev)
        res_ok = True
        res_rows = [r[idx].reshape(len(rows), n).cpu().numpy().view(np.uint32)
                    for r in pending]
        for f, got, fa, fb in zip(rns.fields, res_rows, ra, rb):
            for i, r in enumerate(rows):
                if negacyclic:
                    want = native_oracle.negacyclic_polymul(
                        fa[r], fb[r], f.root_of_unity(2 * n), f.p)
                else:
                    want = native_oracle.cyclic_polymul(
                        fa[r], fb[r], f.root_of_unity(n), f.p)
                res_ok = res_ok and np.array_equal(
                    got[i].astype(np.uint64), want.astype(np.uint64))
        host = np.zeros((len(rows), n), dtype=object)
        for r, e in zip(res_rows, rns._basis):
            host += r.astype(object) * e
        host %= rns.modulus
        host = np.where(host > rns.modulus >> 1, host - rns.modulus, host)
        dev_rows = crt.limbs_to_int(limbs.reshape(B, n, rns.nwords)[idx])
        crt_ok = np.array_equal(dev_rows, host)
        plain = crt.crt_combine_plain(pending, rns._combine)
        err = int((plain.long() - limbs.long()).abs().max())
        max_err = max(max_err, err)
        del plain
        nf = len(rns.fields)
        # one product a prime
        want_launches = ({"colpass": 6 * nf, "fused_fourstep": 0, "crt": 1,
                          "pointwise32": nf}
                         if mat else
                         {"colpass": 0 if negacyclic else 6 * nf,
                          "fused_fourstep": 3 * nf if negacyclic else 0,
                          "crt": 1, "pointwise32": nf})
        counts_ok = launches == want_launches
        ok = bool(res_ok and crt_ok and err == 0 and counts_ok)
        emit({"phase": "rns", "log_n": log_n, "negacyclic": negacyclic,
              "batch": B, "primes": [f.p for f in rns.fields],
              "modulus_bits": rns.modulus.bit_length(),
              "nwords": rns.nwords, "matrix_form": mat,
              "rows": rows.tolist(), "residues_ok": bool(res_ok),
              "crt_rows_ok": bool(crt_ok), "kernel_vs_plain_max_abs_err": err,
              "launches": launches, "launches_ok": counts_ok, "ok": ok})
        if not ok:
            fail("rns", f"RNSPolymul({log_n}, negacyclic={negacyclic}) at "
                 f"B = {B} failed its residue, CRT or launch gates")
            return None
        # timings: host to limbs; the device part; the combine alone
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rns.polymul_limbs(a, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        tas = [torch.from_numpy(v.view(np.int32)).to(dev) for v in ra]
        tbs = [torch.from_numpy(v.view(np.int32)).to(dev) for v in rb]
        key = "negacyclic_polymul" if negacyclic else "polymul"

        def device_part(t):
            outs = []
            for plan, u, v in zip(rns.plans, tas, tbs):
                bat = plan.make_batched(B)
                if mat:
                    shape = (B,) + plan.config.split
                    outs.append(bat[key + "_mat"](u.reshape(shape),
                                                  v.reshape(shape)))
                else:
                    outs.append(bat[key](u, v))
            rns._combine(*outs)
            return t

        dev_us = time_device(device_part, tas[0], iters=3,
                             repeats=3)["us_per_iter"]
        comb_us = time_device(lambda t: (rns._combine(*pending), t)[1],
                              pending[0])["us_per_iter"]
        plain_us = time_device(
            lambda t: (crt.crt_combine_plain(pending, rns._combine), t)[1],
            pending[0], iters=2, repeats=3)["us_per_iter"]
        count = B * n
        nbytes = (nf + rns.nwords) * 4 * count
        line = {"phase": "rns_time", "log_n": log_n,
                "negacyclic": negacyclic, "batch": B, "card": card,
                "polymul_limbs_host_s": sorted(walls)[1],
                "device_us_per_product": dev_us / B,
                "combine_us": comb_us, "combine_plain_us": plain_us,
                "combine_bytes": nbytes,
                "combine_byte_bound_us": nbytes / (SPEC_HBM_GBPS * 1e3),
                "method": "polymul_limbs: host clock around a synchronized "
                          "call, median of 3 (residues on the host, "
                          "uploads, products, combine); device part and "
                          "combine: CUDA events, trimmed mean"}
        emit(line)
        if row is None:
            row = {"launches": launches["crt"], "ms": comb_us / 1e3,
                   "pointwise32_launches": launches["pointwise32"],
                   "plain_ms": plain_us / 1e3, "bytes": nbytes,
                   "count": count, "k": nf, "nwords": rns.nwords,
                   "batch": B, "log_n": log_n}
        del rns, pending, limbs, tas, tbs
        torch.cuda.empty_cache()
    # exactness against the schoolbook integer product
    n = 1 << RNS_EXACT_LOG_N
    for negacyclic in (False, True):
        rns = T.RNSPolymul(RNS_EXACT_LOG_N, negacyclic=negacyclic, device=dev)
        bound = rns.max_input_bound()
        a, b = (rng.integers(-bound, bound + 1, (2, n)) for _ in range(2))
        got = rns.polymul(a, b)
        exact = True
        for r in range(2):
            full = np.convolve(a[r].astype(object), b[r].astype(object))
            want = full[:n].copy()
            want[:n - 1] += (-1 if negacyclic else 1) * full[n:]
            exact = exact and np.array_equal(got[r], want)
        emit({"phase": "rns", "log_n": RNS_EXACT_LOG_N,
              "negacyclic": negacyclic, "batch": 2, "bound": bound,
              "schoolbook_exact": bool(exact), "ok": bool(exact)})
        if not exact:
            fail("rns", f"RNSPolymul({RNS_EXACT_LOG_N}) differs from the "
                 "schoolbook product")
            return None
    row["max_abs_err"] = max_err
    return row


def _pqc_product_key(name, mode, form):
    """The launch counters' key of a fused instantiation."""
    batched = form == "batched" and mode != "serve_fresh"
    return f"{name}_{mode}{'_batched' * batched}"


def _pqc_operands(sch, k, l, form, batch, gen, dev):
    """Random canonical operands (x, a) of a fused instantiation: vectors
    (form None: batch + (256,) both) or vectors batch + (l, 256) against a
    (k, l, 256) matrix shared by the batch or batch + (k, l, 256)."""
    import torch

    bdims = batch if isinstance(batch, tuple) else (batch,)
    if form is None:
        shapes = (bdims + (256,), bdims + (256,))
    else:
        shapes = (bdims + (l, 256),
                  (k, l, 256) if form == "shared" else bdims + (k, l, 256))
    return tuple(torch.randint(0, sch.q, s, dtype=torch.int32, device=dev,
                               generator=gen) for s in shapes)


def _pqc_unfused(x, a, sch, mode):
    """The product as the pipelines ran it before the fused kernel: the
    layered kernel for the transforms, the plain products (torch ops)."""
    from ntt_aie_tpu_torch.ops import ring_layers as LR

    fwd_x, fwd_a, inv, matrix = LR.MODES[mode]
    if fwd_x:
        x = LR.layered(x, sch)
    if fwd_a:
        a = LR.layered(a, sch)
    y = sch.matvec_plain(a, x) if matrix else sch.pointwise_plain(x, a)
    return LR.layered(y, sch, inverse=True) if inv else y


def _cold_copies(nbytes_per_call):
    """The number of input copies a cold reading (utils.timing.time_graph)
    cycles over: copies whose traffic exceeds the 50 MB L2 between two
    uses of one copy."""
    return min(32, max(2, -(-PQC_COLD_BYTES // nbytes_per_call)))


def pqc_phases(args, dev, card, rng):
    """Phase 29: the ML-KEM and ML-DSA rings. pqc_kernel: each of the four
    layered transforms against its plain version raw at B = 1, 3,
    PQC_ODD_BATCH, PQC_BATCH and (8, 3, 256), and each fused ring-product
    instantiation (PQC_PRODUCTS) against ring_product_plain raw at B = 1,
    3, PQC_ODD_BATCH, PQC_BATCH (vectors and a shared matrix),
    PQC_SERVING_BATCH (matrices) and batch (8, 3); pqc: each scheme's
    pipeline on the card (the main path, counters set to 0 just before
    and read just after): ntt and intt at PQC_BATCH (the FIPS roundtrip),
    polymul on 8 rows against the native schoolbook product, pointwise at
    PQC_BATCH and matvec, make_serving_step(A_hat)(x) and serving_step
    (A, x) of PQC_SERVING at PQC_SERVING_BATCH against the plain route
    (the CPU), matvec, make_serving_step and serving_step with a matrix a
    row at PQC_BATCHED_ROWS, launches by call (PQC_LAUNCHES); pqc_time: us per call of the
    pipeline's calls, each kernel alone (a CUDA graph of a chain), the
    plain version and the unfused route (the layered kernel and torch
    ops, as the pipelines ran before) of each fused instantiation.
    Returns the kernels-line rows, or None after emitting the failure."""
    import numpy as np
    import torch

    from ntt_aie_tpu_torch import dilithium, kyber, native_oracle
    from ntt_aie_tpu_torch.ops import ring_layers as LR
    from ntt_aie_tpu_torch.utils.timing import time_device, time_graph

    gen = torch.Generator(device=dev).manual_seed(args.seed + 29)
    mods = {"kyber": kyber, "dilithium": dilithium}
    errs = {}
    for name, mod in mods.items():
        sch = mod.SCHEME
        for inverse in (False, True):
            key = f"{name}_{'intt' if inverse else 'ntt'}"
            errs[key] = 0
            for shape in ((1, 256), (3, 256), (PQC_ODD_BATCH, 256),
                          (PQC_BATCH, 256), (8, 3, 256)):
                x = torch.randint(0, sch.q, shape, dtype=torch.int32,
                                  device=dev, generator=gen)
                got = LR.layered(x, sch, inverse=inverse)
                torch.cuda.synchronize()
                want = LR.layered_plain(x, sch, inverse=inverse)
                err = int((got.long() - want.long()).abs().max())
                errs[key] = max(errs[key], err)
                equal = bool(torch.equal(got, want))
                emit({"phase": "pqc_kernel", "kernel": key,
                      "shape": list(shape), "equal": equal,
                      "max_abs_err": err})
                if not equal:
                    fail("pqc_kernel", f"{key} {shape} differs from its "
                         "plain version")
                    return None
    for name, k, l in PQC_SERVING:
        sch = mods[name].SCHEME
        for mode, form in PQC_PRODUCTS:
            key = _pqc_product_key(name, mode, form)
            errs[key] = 0
            batches = (1, 3, PQC_ODD_BATCH, (8, 3))
            batches += ((PQC_BATCH,) if form is None
                        else (PQC_SERVING_BATCH,) + (PQC_BATCH,)
                        * (form == "shared"))
            for batch in batches:
                x, a = _pqc_operands(sch, k, l, form, batch, gen, dev)
                got = LR.ring_product(x, a, sch, mode)
                torch.cuda.synchronize()
                want = LR.ring_product_plain(x, a, sch, mode)
                equal = bool(got.shape == want.shape
                             and torch.equal(got, want))
                err = (int((got.long() - want.long()).abs().max())
                       if got.shape == want.shape else -1)
                errs[key] = max(errs[key], err)
                emit({"phase": "pqc_kernel", "kernel": key,
                      "x": list(x.shape), "a": list(a.shape),
                      "equal": equal, "max_abs_err": err})
                if not equal:
                    fail("pqc_kernel", f"{key} x {tuple(x.shape)} a "
                         f"{tuple(a.shape)} differs from its plain version")
                    return None
            del x, a, got, want
    torch.cuda.empty_cache()

    rows = []
    for name, k, l in PQC_SERVING:
        mod, sch = mods[name], mods[name].SCHEME
        q, B, Bs = sch.q, PQC_BATCH, PQC_SERVING_BATCH
        pipe = mod.make_pipeline(device=dev)
        plain = mod.make_pipeline(device="cpu")
        x, b = (torch.from_numpy(rng.integers(0, q, (B, 256))).to(dev)
                .to(torch.int32) for _ in range(2))
        a8, b8 = rng.integers(0, q, (2, 8, 256))
        A = rng.integers(0, q, (k, l, 256))
        bA = rng.integers(0, q, (PQC_BATCHED_ROWS, k, l, 256))
        xs = rng.integers(0, q, (Bs, l, 256))
        by = {}

        def drive(call, fn, *operands):
            LR.layered.launches_by = {}
            out = fn(*operands)
            torch.cuda.synchronize()
            by[call] = dict(LR.layered.launches_by)
            return out

        LR.layered.launches = 0
        y = drive("ntt", pipe["ntt"], x)
        back = drive("intt", pipe["intt"], y)
        c8 = drive("polymul", pipe["polymul"], a8, b8)
        pw = drive("pointwise", pipe["pointwise"], y, b)
        A_hat = drive("ntt_A", pipe["ntt"], A)
        mv = drive("matvec", pipe["matvec"], A_hat, xs)
        step = pipe["make_serving_step"](A_hat)
        out = drive("make_serving_step", step, xs)
        fresh = drive("serving_step", pipe["serving_step"], A, xs)
        xb = xs[:PQC_BATCHED_ROWS]
        mv_b = drive("matvec[batched A]", pipe["matvec"], bA, xb)
        step_b = drive("make_serving_step[batched A]",
                       pipe["make_serving_step"](bA), xb)
        fresh_b = drive("serving_step[batched A]", pipe["serving_step"], bA,
                        xb)
        total = LR.layered.launches
        want_by = {call: {f"{name}_{key}": n for key, n in want.items()}
                   for call, want in PQC_LAUNCHES.items()}
        want_out = plain["make_serving_step"](plain["ntt"](A))(xs)
        checks = {
            "roundtrip": bool(torch.equal(back, x)),
            "polymul_schoolbook": all(
                np.array_equal(c8[r].cpu().numpy().astype(np.uint64),
                               native_oracle.schoolbook_negacyclic(
                                   a8[r], b8[r], q))
                for r in range(8)),
            "pointwise_equals_plain": bool(torch.equal(
                pw.cpu(), plain["pointwise"](y.cpu(), b.cpu()))),
            "A_hat_equals_plain": bool(torch.equal(A_hat.cpu(),
                                                   plain["ntt"](A))),
            "matvec_equals_plain": bool(torch.equal(
                mv.cpu(), plain["matvec"](A_hat.cpu(), xs))),
            "serving_shape": tuple(out.shape) == (Bs, k, 256),
            "serving_equals_plain": bool(torch.equal(out.cpu(), want_out)),
            "serving_step_equals_plain": bool(torch.equal(fresh.cpu(),
                                                          want_out)),
            "matvec_batched_equals_plain": bool(torch.equal(
                mv_b.cpu(), plain["matvec"](bA, xb))),
            "serving_batched_equals_plain": bool(torch.equal(
                step_b.cpu(), plain["make_serving_step"](bA)(xb))),
            "serving_step_batched_equals_plain": bool(torch.equal(
                fresh_b.cpu(), plain["serving_step"](bA, xb))),
            "launches": by == want_by,
        }
        ok = all(checks.values())
        emit({"phase": "pqc", "scheme": name, "q": q, "batch": B,
              "serving": {"k": k, "l": l, "batch": Bs,
                          "batched_rows": PQC_BATCHED_ROWS},
              "oracle": "native schoolbook", "checks": checks,
              "launches_by_call": by, "launches": total, "ok": ok})
        if not ok:
            fail("pqc", f"the {name} pipeline disagrees with its oracles or "
                 "did not launch as expected")
            return None
        del y, back, pw, mv, out, fresh, mv_b, step_b, fresh_b

        # timing: the pipeline's calls (wrapper and kernels), each kernel
        # alone, the plain versions, the unfused route
        xs_dev = torch.from_numpy(xs).to(dev).to(torch.int32)
        A_dev = torch.from_numpy(A).to(dev).to(torch.int32)
        us = {"ntt": time_device(pipe["ntt"], x)["us_per_iter"],
              "intt": time_device(pipe["intt"], x)["us_per_iter"],
              "polymul": time_device(lambda v: pipe["polymul"](v, b),
                                     x)["us_per_iter"],
              "pointwise": time_device(lambda v: pipe["pointwise"](v, b),
                                       x)["us_per_iter"]}
        for call, fn in (("make_serving_step", step),
                         ("serving_step",
                          lambda v: pipe["serving_step"](A_dev, v))):
            us[call] = time_device(lambda v, f=fn: f(v)[:, :l], xs_dev,
                                   iters=20, repeats=3)["us_per_iter"]
        kernel_us, warm_us, plain_us, small_us, unfused_us = {}, {}, {}, {}, {}
        xp = x[:PQC_PLAIN_BATCH]
        fwd, inv = f"{name}_ntt", f"{name}_intt"
        xc = [x] + [x.clone() for _ in range(_cold_copies(8 * x.numel()) - 1)]
        for inverse in (False, True):
            key = inv if inverse else fwd
            kernel_us[key] = time_graph(
                lambda v, i=inverse: LR.layered(v, sch, inverse=i), xc)
            warm_us[key] = time_graph(
                lambda v, i=inverse: LR.layered(v, sch, inverse=i), [x])
            plain_us[key] = time_device(
                lambda v, i=inverse: LR.layered_plain(v, sch, inverse=i), x,
                iters=2, repeats=3)["us_per_iter"]
            small_us[key] = time_device(
                lambda v, i=inverse: LR.layered_plain(v, sch, inverse=i), xp,
                iters=2, repeats=3)["us_per_iter"]
        del xc
        for mode, form in PQC_PRODUCTS:
            key = _pqc_product_key(name, mode, form)
            xf, af = _pqc_operands(sch, k, l, form,
                                   B if form is None else Bs, gen, dev)
            out_bytes = 4 * xf.numel() // xf.shape[-2] * k if form else \
                4 * xf.numel()
            copies = _cold_copies(4 * xf.numel() + out_bytes
                                  + (0 if form == "shared" else 4 * af.numel()))
            pairs = [(xf, af)] + [
                (xf.clone(), af if form == "shared" else af.clone())
                for _ in range(copies - 1)]
            kernel_us[key] = time_graph(
                lambda v, m=mode: LR.ring_product(*v, sch, m), pairs)
            warm_us[key] = time_graph(
                lambda v, m=mode: LR.ring_product(*v, sch, m), pairs[:1])
            del pairs
            plain_us[key] = time_device(
                lambda v, m=mode: LR.ring_product_plain(xf, af, sch, m), xf,
                iters=2, repeats=3)["us_per_iter"]
            unfused_us[key] = time_device(
                lambda v, m=mode: _pqc_unfused(xf, af, sch, m), xf,
                iters=2, repeats=3)["us_per_iter"]
            del xf, af
        per_s = {c: (Bs if "serving" in c else B) / (t * 1e-6)
                 for c, t in us.items()}
        emit({"phase": "pqc_time", "scheme": name, "card": card,
              "batch": B, "serving_batch": Bs, "us_per_call": us,
              "polys_per_s": per_s, "kernel_alone_us": kernel_us,
              "kernel_alone_l2_warm_us": warm_us,
              "plain_us": plain_us, "unfused_us": unfused_us,
              "plain_small_batch": PQC_PLAIN_BATCH,
              "plain_small_us": small_us,
              "method": "CUDA events; calls: 5 repeats of a dependent "
                        "chain of 10 (serving steps: 3 of 20), trimmed "
                        "mean; polymul(x, b), pointwise(x, b); serving "
                        "steps x -> step(x)[:, :l]; polys_per_s = batch "
                        "/ us per call (the serving steps: vectors); "
                        "kernel alone: a CUDA graph of max(20, copies) "
                        "launches cycling over copies of the inputs "
                        "whose traffic exceeds the L2 between two uses "
                        "of a copy (cold), 5 replays, trimmed mean (the "
                        "fused products at B = batch for vectors, "
                        "serving_batch for matrices; a shared matrix "
                        "stays one copy); l2 warm: the same graph on one "
                        "input; plain and unfused (the layered kernel "
                        "and torch ops): 3 of 2"})
        for key in (fwd, inv):
            rows.append({
                "name": f"ring_layers[{key}]", "route": "cuda",
                "source": "ntt_aie_tpu_torch/csrc/ring_layers.cu",
                "replaces": "ntt_aie_tpu/ring_layers.py:49 (XLA, a helper "
                            "kernel)",
                "launches": sum(v.get(key, 0) for v in by.values()),
                "launches_by_call": {c: v.get(key, 0) for c, v in by.items()},
                "max_abs_err": errs[key], "ms": kernel_us[key] / 1e3,
                "l2_warm_ms": warm_us[key] / 1e3,
                "wrapper_ms": us["ntt" if key == fwd else "intt"] / 1e3,
                "plain_ms": plain_us[key] / 1e3, "batch": B,
                "plain_batch": B, "bytes": B * 256 * 4 * 2,
                "butterflies": B * 128 * sch.n_layers,
                "arithmetic": "barrett" if name == "kyber" else "montgomery"})
        for mode, form in PQC_PRODUCTS:
            key = _pqc_product_key(name, mode, form)
            fwd_x, fwd_a, inverse, _ = LR.MODES[mode]
            rb, kk, ll = (B, 1, 1) if form is None else (Bs, k, l)
            a_polys = kk * ll * (1 if form == "shared" else rb)
            transform = rb * 128 * sch.n_layers * (
                fwd_x * ll + fwd_a * kk * ll + inverse * kk)
            products = rb * kk * ll * 256
            rows.append({
                "name": f"ring_layers[{key}]", "route": "cuda",
                "source": "ntt_aie_tpu_torch/csrc/ring_layers.cu",
                "replaces": PQC_REPLACES[name][mode],
                "launches": sum(v.get(key, 0) for v in by.values()),
                "launches_by_call": {c: v.get(key, 0) for c, v in by.items()},
                "max_abs_err": errs[key], "ms": kernel_us[key] / 1e3,
                "l2_warm_ms": warm_us[key] / 1e3,
                "plain_ms": plain_us[key] / 1e3,
                "unfused_ms": unfused_us[key] / 1e3, "batch": rb,
                "plain_batch": rb, "k": kk, "l": ll, "a": form or "batched",
                "bytes": 1024 * (rb * ll + a_polys + rb * kk),
                "butterflies": transform + products,
                "transform_butterflies": transform, "products": products,
                "arithmetic": "barrett" if name == "kyber" else "montgomery"})
        del pipe, x, b, xs_dev, A_dev
        torch.cuda.empty_cache()
    return rows


def reference_parity_phase(args, dev, card, rng):
    """Phase 30: the reference-parity plan (PARITY_CASES) on the card: the
    paper's configuration (Kyber, n = 2048, ordering='reference', a[i] =
    i) against reference.reference_device_output and the native network
    with block_permute16, and p = 469762049 (harvey4) at n = 2^20 against
    the NumPy and native networks; NTTContext.forward_host against the
    same; fwd timed. Returns True, or None after emitting the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle, reference
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.utils.timing import time_device

    for name, log_n, ordering in PARITY_CASES:
        field = T.FIELDS[name]
        p, n = field.p, 1 << log_n
        cfg = T.NTTConfig(field=field, log_n=log_n,
                          table_convention="reference", ordering=ordering)
        plan = T.build_plan(cfg, device=dev)
        a = np.arange(n) if name == "kyber" else rng.integers(0, p, n)
        x = torch.from_numpy(a).to(dev)
        got = plan.fwd(x).cpu().numpy().astype(np.int64)
        want = reference.reference_network(a, tw.power_table(field, n), p)
        native = native_oracle.reference_network(
            a, native_oracle.make_power_table(n, p, field.g), p)
        if ordering == "reference":
            want = reference.block_permute(want)
            native = native_oracle.block_permute16(native)
        checks = {"numpy": bool(np.array_equal(got, want)),
                  "native": bool(np.array_equal(got, native)),
                  "forward_host": bool(np.array_equal(
                      T.NTTContext(cfg, device=dev).forward_host(a), got))}
        if name == "kyber":
            checks["reference_device_output"] = bool(np.array_equal(
                got, reference.reference_device_output(a, field, n)))
        ok = all(checks.values())
        emit({"phase": "reference_parity", "field": name, "p": p, "n": n,
              "ordering": ordering, "reduction": plan.reduction,
              "input": "a[i] = i" if name == "kyber" else "random",
              "checks": checks, "ok": ok})
        if not ok:
            fail("reference_parity", f"the {name} n = 2^{log_n} parity plan "
                 "differs from the reference network")
            return None
        xi = x.to(torch.int32)
        emit({"phase": "reference_parity_time", "field": name, "n": n,
              "card": card, "reduction": plan.reduction,
              "fwd_us_per_call": time_device(plan.fwd, xi)["us_per_iter"],
              "method": "CUDA events; 5 repeats of a dependent chain of 10, "
                        "trimmed mean; torch ops, no kernel of the port"})
        del plan, x, xi
        torch.cuda.empty_cache()
    return True


def flat_n2_phase(dev, gen, rng):
    """Phase 20, n = 2 (FLAT_N2): the flat plan of n = 2 (the stage loops
    as torch ops) over p = 469762049 and Goldilocks at FLAT_N2_BATCH:
    fwd, inv (the roundtrip), polymul and negacyclic_polymul through
    make_batched against the native oracle on row 0 plus 8 random rows,
    and the flat callables on row 0; launches (no column pass or fused
    transform; the products the 32-bit pointwise kernel's, or gl_mul's
    for Goldilocks). Returns {kernel row:
    launches}, or None after emitting the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.ops import pointwise as PW

    launches = {}
    B = FLAT_N2_BATCH
    for name in FLAT_N2:
        field = T.FIELDS[name]
        p, gl = field.p, field.is_goldilocks
        rows_u64, same, _, _ = _flat_ops(gl)
        plan = T.build_plan(T.NTTConfig(field=field, log_n=1,
                                        negacyclic=True), device=dev)
        bat = plan.make_batched(B)
        if gl:
            x, y = (M.gl_from_u64(rng.integers(0, 1 << 64, (B, 2),
                                               dtype=np.uint64)
                                  % np.uint64(p), dev) for _ in range(2))
        else:
            x, y = (torch.randint(0, p, (B, 2), dtype=torch.int32,
                                  device=dev, generator=gen)
                    for _ in range(2))
        counters = (C.colpass, F.fused_fourstep, G.gl_colpass, G.gl_mul,
                    PW.mul32)
        by = {}

        def drive(call, fn, *operands):
            for c in counters:
                c.launches = 0
            out = fn(*operands)
            torch.cuda.synchronize()
            by[call] = [c.launches for c in counters]
            return out

        gate = np.concatenate([[0], rng.choice(np.arange(1, B), size=8,
                                               replace=False)])
        gidx = torch.from_numpy(gate).to(dev)
        xin, yin = rows_u64(x, gidx), rows_u64(y, gidx)
        omega, psi = field.root_of_unity(2), field.root_of_unity(4)
        f = drive("fwd", bat["fwd"], x)
        back = drive("inv", bat["inv"], f)
        c = drive("polymul", bat["polymul"], x, y)
        d = drive("negacyclic_polymul", bat["negacyclic_polymul"], x, y)
        want_f = native_oracle.ntt_dif_batch(xin, omega, p)
        u0, v0 = ((r[0] if gl else r[0].astype(np.int64)) for r in (xin, yin))
        host = (lambda v: np.asarray(v if gl else v.cpu().numpy())
                .astype(np.uint64))
        checks = {
            "fwd": np.array_equal(rows_u64(f, gidx), want_f),
            "roundtrip": same(back, x),
            "polymul": all(np.array_equal(r, native_oracle.cyclic_polymul(
                u, v, omega, p)) for r, u, v in zip(rows_u64(c, gidx), xin,
                                                    yin)),
            "negacyclic_polymul": all(
                np.array_equal(r, native_oracle.negacyclic_polymul(
                    u, v, psi, p))
                for r, u, v in zip(rows_u64(d, gidx), xin, yin)),
            "flat": (np.array_equal(host(plan.fwd(u0)), want_f[0])
                     and np.array_equal(
                         host(plan.negacyclic_polymul(u0, v0)),
                         native_oracle.negacyclic_polymul(xin[0], yin[0],
                                                          psi, p))),
        }
        # the products: gl_mul for Goldilocks, the 32-bit kernel otherwise
        products = {"fwd": 0, "inv": 0, "polymul": 1,
                    "negacyclic_polymul": 4}
        want = {k: [0, 0, 0, v if gl else 0, 0 if gl else v]
                for k, v in products.items()}
        checks["launches"] = by == want
        checks = {k: bool(v) for k, v in checks.items()}
        ok = all(checks.values())
        emit({"phase": "flat", "flat": "n2", "field": name, "p": p, "n": 2,
              "batch": B, "route": "stage loops (torch ops)",
              "oracle": "native", "gate_rows": gate.tolist(),
              "checks": checks, "launches": by, "ok": ok})
        if not ok:
            fail("flat", f"n = 2 over {name}: the flat plan disagrees with "
                 "the native oracle or launched a kernel it should not")
            return None
        row, col = ("gl_mul", 3) if gl else ("pointwise32", 4)
        launches[row] = launches.get(row, 0) + sum(v[col]
                                                   for v in by.values())
    return launches


# The distributed slice (phases 31-33). The kernel phase holds every column
# pass of the distributed plan against its plain version at the north-star
# split (n = 2^24, 4096 x 4096) on rank 0 of D = 4 with C = 2 chunks (pass 1
# over (B, 4096, 1024), pass 2 over (B, 4096, 512)), and times the
# instantiations this slice added, at a batch of DIST_KERNEL_BATCH.
DIST_N1 = DIST_N2 = 4096
DIST_D, DIST_C = 4, 2
DIST_KERNEL_BATCH = 8
# (row, kernel, factored arm, pass, variant): the instantiations the
# distributed plan added to the column kernels (PERF.md rows 1d and 3d)
DIST_NEW = (
    ("colpass[dist:lcp1]", "colpass", False, "lcp1", "dif+post"),
    ("colpass[dist:lcp1n]", "colpass", False, "lcp1n", "dif+pre+post"),
    ("colpass[dist:factored:lcp1n]", "colpass", True, "lcp1n",
     "dif+rank1_pre"),
    ("colpass[dist:factored:licp2]", "colpass", True, "licp2",
     "dit+wfac_post"),
    ("gl_colpass[dist:lcp1]", "gl_colpass", False, "lcp1", "dif+post"),
    ("gl_colpass[dist:lcp1n]", "gl_colpass", False, "lcp1n", "dif+pre+post"),
    ("gl_colpass[dist:licp1n]", "gl_colpass", False, "licp1n",
     "dit+pre+post"),
    ("gl_colpass[dist:factored:lcp1n]", "gl_colpass", True, "lcp1n",
     "dif+rank1_pre"),
    ("gl_colpass[dist:factored:licp1n]", "gl_colpass", True, "licp1n",
     "dit+rank1_post"),
    ("gl_colpass[dist:factored:licp2]", "gl_colpass", True, "licp2",
     "dit+wfac_post"),
)
# The distributed path (phase 32): D = 4 ranks that share the card, gloo's
# all_to_all_single on CUDA tensors. (name, kind, field name, log_n,
# rows_log2, mesh, plan keywords, batch, calls)
DIST_NEGA = ["fwd", "inv", "polymul", "negacyclic_polymul"]
DIST_CASES = (
    ("factored", "plan", "p469762049", 24, 12, ("flat", 4),
     {"overlap_chunks": 2}, None, DIST_NEGA),
    ("full", "plan", "p469762049", 24, 12, ("flat", 4),
     {"wmat_factored": False, "overlap_chunks": 2}, None, DIST_NEGA),
    ("dp_2x2", "plan", "p469762049", 22, 11, ("2d", 2, 2),
     {"dp_axis": "dp", "overlap_chunks": 2}, 4, ["fwd", "inv", "polymul"]),
    ("hier_2x2", "plan", "p469762049", 24, 12, ("hier", 2, 2),
     {"hier_axes": ("dcn", "ici"), "overlap_chunks": 2}, None,
     ["fwd", "inv"]),
    ("pairwise", "pairwise", "p469762049", 24, None, ("flat", 4), {}, None,
     ["fwd"]),
    ("gl_factored", "gl", "goldilocks", 20, 10, ("flat", 4),
     {"overlap_chunks": 2}, None, DIST_NEGA),
    ("gl_full", "gl", "goldilocks", 20, 10, ("flat", 4),
     {"wmat_factored": False, "overlap_chunks": 2}, None, DIST_NEGA),
)
DIST_TIME_REPEATS = 3
# One NCCL rank (phase 33): the factored plan at n = 2^20 (1024 x 1024)
NCCL_LOG_N = 20


def _dist_draw(kern, shape, p, gen, dev, rng):
    import numpy as np
    import torch

    from ntt_aie_tpu_torch.ops import modops as M

    if kern == "gl_colpass":
        vals = rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(p)
        return M.gl_from_u64(vals, dev)
    return torch.randint(0, 4 * p, shape, dtype=torch.int64, device=dev,
                         generator=gen).to(torch.int32)


def _dist_shape(name, B):
    if name in ("lcp2", "licp2"):
        return (B, DIST_N2, DIST_N1 // (DIST_D * DIST_C))
    return (B, DIST_N1, DIST_N2 // DIST_D)


def dist_kernel_phase(args, dev, card):
    """Phase 31: every column pass of the distributed plan (dist_passes,
    gl_dist_passes: both arms, negacyclic) of rank 0 at the 4096 x 4096
    split, D = 4, C = 2, kernel against plain, raw, at a batch of 2; the
    instantiations this slice added (DIST_NEW) timed alone at
    DIST_KERNEL_BATCH with their plain versions and kernel_info. Returns
    ({variant key: max_abs_err}, {row: timing}), or None after emitting
    the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.parallel import fourstep as FS
    from ntt_aie_tpu_torch.utils.timing import time_device

    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    rng = np.random.default_rng(args.seed + 31)
    ops = {"colpass": (C.colpass, C.colpass_plain, C.kernel_info, C.variant,
                       T.P_469762049),
           "gl_colpass": (G.gl_colpass, G.gl_colpass_plain, G.kernel_info,
                          G.variant, T.GOLDILOCKS)}
    passes = {}
    for kern, (_, _, _, _, field) in ops.items():
        build = FS.gl_dist_passes if kern == "gl_colpass" else FS.dist_passes
        for arm in (True, False):
            passes[kern, arm] = build(field, DIST_N1, DIST_N2, DIST_D, DIST_C,
                                      0, wmat_factored=arm, negacyclic=True,
                                      device=dev)
    errs = {}
    for (kern, arm), ps in passes.items():
        run, plain, _, variant, field = ops[kern]
        for name, cps in ps.items():
            for cp in (cps if isinstance(cps, list) else [cps]):
                x = _dist_draw(kern, _dist_shape(name, 2), field.p, gen, dev,
                               rng)
                got = run(x, cp)
                torch.cuda.synchronize()
                want = plain(x, cp)
                pairs = (zip(got, want) if isinstance(got, tuple)
                         else [(got, want)])
                err = max(int((u.long() - v.long()).abs().max())
                          for u, v in pairs)
                key = f"{kern}:{variant(cp)}"
                errs[key] = max(errs.get(key, 0), err)
                if err:
                    emit({"phase": "dist_kernel", "kernel": kern,
                          "factored": arm, "pass": name,
                          "variant": variant(cp), "max_abs_err": err,
                          "ok": False})
                    fail("dist_kernel", f"{kern} {name} ({variant(cp)}) "
                         "differs from its plain version")
                    return None
    emit({"phase": "dist_kernel", "split": [DIST_N1, DIST_N2], "D": DIST_D,
          "C": DIST_C, "batch": 2, "max_abs_err": errs, "ok": True})
    timing = {}
    B = DIST_KERNEL_BATCH
    for row, kern, arm, name, want_variant in DIST_NEW:
        run, plain, info_of, variant, field = ops[kern]
        cp = passes[kern, arm][name]
        cp = cp[0] if isinstance(cp, list) else cp
        if variant(cp) != want_variant:
            fail("dist_kernel", f"{row} is {variant(cp)}, not "
                 f"{want_variant}")
            return None
        x = _dist_draw(kern, _dist_shape(name, B), field.p, gen, dev, rng)
        us = time_device(cp, x)["us_per_iter"]
        plain_us, pb = _plain_batch_time(lambda v, c=cp: plain(v, c), x, 2)
        shape = _dist_shape(name, B)
        timing[row] = {"variant": want_variant, "shape": list(shape),
                       "us_per_call": us, "plain_us_per_call": plain_us,
                       "plain_batch": pb,
                       "kernel_info": info_of(cp, shape[2])}
    emit({"phase": "dist_kernel_time", "card": card, "batch": B,
          "rows": timing,
          "method": "CUDA events; 5 repeats of a dependent chain of 10, "
                    "trimmed mean; plain: 3 repeats of 2"})
    del passes
    torch.cuda.empty_cache()
    return errs, timing


def _dist_spec(case, rng):
    """A phase-32 case as parallel.runs takes it, inputs from rng."""
    import numpy as np

    import ntt_aie_tpu_torch as T

    name, kind, field_name, log_n, rows, mesh, plan, batch, calls = case
    p = T.FIELDS[field_name].p
    n = 1 << log_n
    shape = (n,) if batch is None else (batch, n)
    if field_name == "goldilocks":
        a, b = (rng.integers(0, p, shape, dtype=np.uint64) for _ in range(2))
    else:
        a, b = (rng.integers(0, p, shape).astype(np.uint32) for _ in range(2))
    shards = {"flat": mesh[1:], "2d": mesh[2:], "hier": mesh[1:]}[mesh[0]]
    config = {"num_shards": int(np.prod(shards)),
              "negacyclic": "negacyclic_polymul" in calls}
    if rows is not None:
        config["rows_log2"] = rows
    return dict(kind=kind, field=field_name, log_n=log_n, config=config,
                mesh=mesh, plan=plan, a=a, b=b, calls=calls,
                time=DIST_TIME_REPEATS)


def _single_outputs(spec, dev):
    """The single-device plan of a case's configuration, and its outputs on
    the case's inputs: {call: host array}, flat per transform."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import modops as M

    field = T.FIELDS[spec["field"]]
    cfg = T.NTTConfig(field=field, log_n=spec["log_n"],
                      **{k: v for k, v in spec["config"].items()
                         if k != "num_shards"})
    plan = T.build_plan(cfg, device=dev, wmat_factored=True)
    a, b = spec["a"], spec["b"]
    gl = field.is_goldilocks
    lead = () if a.ndim == 1 else (a.shape[0],)
    calls = plan.make_batched(lead[0]) if lead else {
        "fwd": plan.fwd, "polymul": plan.polymul,
        "negacyclic_polymul": plan.negacyclic_polymul}

    def dev_in(v):
        if gl:
            return M.gl_from_u64(v, dev)
        return torch.from_numpy(v.view(np.int32)).to(dev)

    def host(v):
        if gl:
            return M.gl_to_u64(*v)
        return v.cpu().numpy().view(np.uint32)

    out = {"fwd": host(calls["fwd"](dev_in(a)))}
    if "polymul" in spec["calls"]:
        out["polymul"] = host(calls["polymul"](dev_in(a), dev_in(b)))
    if "negacyclic_polymul" in spec["calls"]:
        out["negacyclic_polymul"] = host(calls["negacyclic_polymul"](
            dev_in(a), dev_in(b)))
    return plan, out


def dist_path_phase(args, dev, card, rng):
    """Phase 32: the distributed path on DIST_D ranks that share the card
    (run_spmd, gloo with CUDA tensors; the libraries were built in phase
    2, before the spawn), DIST_CASES: each callable's gathered output
    against the single-device plan at the same split (bit for bit), fwd
    also against the native oracle, the round trip against the input, the
    pairwise mode against the single-device spectrum in bit-reversed
    order and the native DIF; launches by instantiation from each case's
    driven calls (counted from 0 in every rank just before them); each
    call timed. Returns {kernel: {variant: launches}} summed over the
    ranks and cases, or None after emitting the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch import twiddles as tw
    from ntt_aie_tpu_torch.parallel import launch, runs

    specs = [_dist_spec(case, rng) for case in DIST_CASES]
    for spec in specs:  # the pairwise mode transforms the first case's input
        if spec["kind"] == "pairwise":
            if spec["log_n"] != specs[0]["log_n"]:
                raise ValueError("the pairwise case needs the first case's n")
            spec["a"] = specs[0]["a"]
    t0 = time.perf_counter()
    res = launch.run_spmd(runs.run_cases, DIST_D, backend="gloo",
                          device_type="cuda", args=(specs, "cuda"))
    wall = time.perf_counter() - t0
    totals = {}
    lines = []
    single_fwd = {}
    for i, (case, spec) in enumerate(zip(DIST_CASES, specs)):
        name, kind, field_name = case[:3]
        checks = {}
        got = {k: runs.assemble(res, i, k) for k in spec["calls"]}
        n, a = 1 << spec["log_n"], spec["a"]
        if kind == "pairwise":
            # the single-device spectrum of the same input at the square
            # split (the first case's), in bit-reversed order
            n1 = n2 = 1 << (spec["log_n"] // 2)
            flat = single_fwd[spec["log_n"]].reshape(-1)[
                tw.flat_gather(n1, n2)]
            checks["single_device_bitrev"] = bool(np.array_equal(
                got["fwd"], flat))
            field = T.FIELDS[field_name]
            native = native_oracle.ntt_dif_batch(
                a[None].astype(np.uint64), field.root_of_unity(n), field.p)[0]
            checks["native"] = bool(np.array_equal(
                got["fwd"].astype(np.uint64), native.astype(np.uint64)))
        else:
            plan, want = _single_outputs(spec, dev)
            if spec["a"].ndim == 1 and field_name != "goldilocks":
                single_fwd.setdefault(spec["log_n"], want["fwd"])
            batch = a.shape[0] if a.ndim == 2 else 1
            for k in spec["calls"]:
                if k == "inv":
                    checks[k] = bool(np.array_equal(
                        got[k].reshape(a.shape), a))
                else:
                    checks[k] = bool(np.array_equal(
                        got[k].reshape(-1), want[k].reshape(-1)))
            y = got["fwd"].reshape(batch, -1)[:1]
            x = a.reshape(batch, -1)[:1]
            if field_name == "goldilocks":
                from ntt_aie_tpu_torch.ops import modops as M

                yd, xd = (M.gl_from_u64(v, dev) for v in (y, x))
            else:
                yd, xd = (torch.from_numpy(v.view(np.int32)).to(dev)
                          for v in (y, x))
            checks["native_fwd"] = _gate_fwd(
                yd, xd, np.array([0]), T.FIELDS[field_name],
                plan.spectral_to_natural, dev)
            del plan
            torch.cuda.empty_cache()
        launches = {}
        for r in res:
            for kern, by in r[i]["launches"].items():
                for variant, count in by.items():
                    launches.setdefault(kern, {})
                    launches[kern][variant] = (launches[kern].get(variant, 0)
                                               + count)
                    totals.setdefault(kern, {})
                    totals[kern][variant] = (totals[kern].get(variant, 0)
                                             + count)
        ms = {k: max(r[i]["ms"][k] for r in res) for k in spec["calls"]}
        line = {"case": name, "kind": kind, "field": field_name,
                "n": n, "split": spec["config"].get("rows_log2"),
                "mesh": list(case[5]), "plan": {k: list(v) if
                                                isinstance(v, tuple) else v
                                                for k, v in case[6].items()},
                "batch": case[7], "checks": checks, "launches_by": launches,
                "ms_per_call": ms, "ok": all(checks.values())}
        lines.append(line)
        emit(dict(line, phase="distributed_case"))
        if not line["ok"]:
            fail("distributed", f"case {name} differs from the single-device "
                 "plan or the native oracle")
            return None
    backends = {r[0]["backend"] for r in res}
    emit({"phase": "distributed", "card": card, "backend": sorted(backends),
          "world": DIST_D, "transport": "gloo all_to_all_single on CUDA "
          "tensors (gloo stages them through the host), the ranks sharing "
          "one card", "spawn_and_run_s": wall,
          "cases": [{k: line[k] for k in ("case", "n", "mesh", "plan",
                                          "batch", "ms_per_call")}
                    for line in lines],
          "note": "not a multi-chip figure: the collective is gloo staged "
                  "through the host on one shared card; ms_per_call is the "
                  "slowest rank's median of "
                  f"{DIST_TIME_REPEATS} calls between barriers",
          "ok": True})
    return totals


def nccl_phase(args, dev, card, rng):
    """Phase 33: one rank on NCCL (world = 1): the factored plan at
    n = 2^NCCL_LOG_N with two chunks, its collective NCCL's
    all_to_all_single, every callable against the single-device plan.
    Returns its launches by instantiation, or None after emitting the
    failure."""
    import numpy as np

    from ntt_aie_tpu_torch.parallel import launch, runs

    case = ("nccl", "plan", "p469762049", NCCL_LOG_N, NCCL_LOG_N // 2,
            ("flat", 1), {"overlap_chunks": 2}, None, DIST_NEGA)
    spec = _dist_spec(case, rng)
    res = launch.run_spmd(runs.run_cases, 1, backend="nccl",
                          device_type="cuda", args=([spec], "cuda"))
    _, want = _single_outputs(spec, dev)
    got = {k: runs.assemble(res, 0, k) for k in spec["calls"]}
    checks = {k: bool(np.array_equal(got[k].reshape(-1), want[k].reshape(-1))
                      if k != "inv" else np.array_equal(got[k].reshape(-1),
                                                        spec["a"]))
              for k in spec["calls"]}
    r = res[0][0]
    ok = all(checks.values()) and r["backend"] == "nccl" and sum(
        r["launches"]["colpass"].values()) > 0
    emit({"phase": "nccl", "card": card, "backend": r["backend"],
          "world": 1, "n": spec["log_n"], "checks": checks,
          "launches_by": r["launches"], "ms_per_call": r["ms"], "ok": ok})
    if not ok:
        fail("nccl", "the one-rank NCCL plan differs from the single-device "
             "plan")
        return None
    return r["launches"]


def _dist_rows(errs, timing, launches):
    """The kernels-line rows of the instantiations the distributed plan
    added (PERF.md rows 1d and 3d): ms per launch at DIST_KERNEL_BATCH
    (phase 31), launches from phase 32's driven calls summed over the
    ranks, launches a transform (pass 1: one a rank; pass 2: one a chunk
    a rank), bytes the input and output once and the operand tables once
    (pairs of 8 bytes for the 32-bit kernel, uint64 for Goldilocks), the
    column network's butterflies. A pass on its tall route (Goldilocks's
    4,096-row columns, above GL_LAUNCH_ROWS) is timed whole, its launches
    a call under "pass_launches", its largest registers and fewest blocks
    an SM."""
    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch import twiddles as tw

    s = tw.default_wfac_split(DIST_N2)
    rows = []
    for row, kern, arm, name, variant in DIST_NEW:
        t = timing[row]
        B, nn, cols = t["shape"]
        gl = kern == "gl_colpass"
        word = 8 if gl else 4
        tables = {"dif+post": nn * cols * 8, "dif+pre+post": 2 * nn * cols * 8,
                  "dit+pre+post": 2 * nn * cols * 8,
                  "dif+rank1_pre": (nn + cols) * 8,
                  "dit+rank1_post": (nn + cols) * 8,
                  "dit+wfac_post": (DIST_N2 // s + s) * cols * 8}[variant]
        info = t["kernel_info"]
        phases = info.get("phases", [info])
        rows.append({
            "name": row, "perf_row": "3d" if gl else "1d", "route": "cuda",
            "source": f"ntt_aie_tpu_torch/csrc/{kern}.cu",
            "replaces": ("ntt_aie_tpu/ops/pallas_gl.py:33" if gl
                         else "ntt_aie_tpu/ops/pallas_ntt.py:298"),
            "variant": variant,
            "launches": launches.get(kern, {}).get(variant, 0),
            "launches_per_transform": (DIST_D * DIST_C if name == "licp2"
                                       else DIST_D),
            "max_abs_err": errs.get(f"{kern}:{variant}", 0),
            "ms": t["us_per_call"] / 1e3,
            "plain_ms": t["plain_us_per_call"] / 1e3,
            "batch": B, "plain_batch": t["plain_batch"],
            "bytes": 2 * B * nn * cols * word + tables, "table_bytes": tables,
            "butterflies": B * cols * nn // 2 * (nn.bit_length() - 1),
            "arithmetic": "goldilocks" if gl else "harvey4",
            "field": (T.GOLDILOCKS if gl else T.P_469762049).name,
            "pass_launches": len(phases),
            "registers": max(i["registers"] for i in phases),
            "blocks_per_sm": min(i["blocks_per_sm"] for i in phases)})
    return rows


def distributed_phases(args, dev, card, rng):
    """Phases 31-33. Returns the kernels-line rows of DIST_NEW, or None
    after emitting the failure. Every instantiation of DIST_NEW must have
    launched in phase 32's driven calls."""
    got = dist_kernel_phase(args, dev, card)
    if got is None:
        return None
    errs, timing = got
    launches = dist_path_phase(args, dev, card, rng)
    if launches is None:
        return None
    missing = [row for row, kern, _, _, variant in DIST_NEW
               if not launches.get(kern, {}).get(variant)]
    if missing:
        fail("distributed", f"the distributed path launched none of {missing}")
        return None
    if nccl_phase(args, dev, card, rng) is None:
        return None
    return _dist_rows(errs, timing, launches)



# Phases 34-38: the entry points a user calls. The CLI's verify runs
# (argv) and bench cells ((field, log_n, batch) for each op); the trace
# cells ((label, op, extra flags)); the sweep's grid; the scaling cells;
# the streamed batches.
CLI_VERIFY = (["verify", "--field", "P_2013265921", "--log-n", "12",
               "--native"],
              ["verify", "--field", "KYBER", "--log-n", "8", "--native"],
              ["verify", "--field", "DILITHIUM", "--log-n", "8", "--native"],
              ["verify", "--field", "GOLDILOCKS", "--log-n", "12"],
              ["verify", "--parity"])
CLI_BENCH = (("P_469762049", 20, 256), ("GOLDILOCKS", 20, 64))
CLI_BENCH_ITERS = ("--iters", "5", "--repeats", "3")
TRACE_LOG_N = 20
# The profiler has once dropped the first kernel event of a capture (one
# of six whole runs of phase 35 on the H100): a capture whose rows miss a
# pass is taken again, up to this many times, and its attempts reported;
# every check applies unchanged to the capture that is kept.
TRACE_ATTEMPTS = 3
TRACE_CELLS = (("fwd", "fwd", []), ("inv", "inv", []),
               ("polymul", "polymul", []),
               ("fwd_no_fold", "fwd", ["--no-wmat-fold"]),
               ("fwd_factored", "fwd", ["--wmat-factored"]))
# (kDit, kTranspose) of the derived rows, in program order
TRACE_ORDER = {"fwd": [(False, True), (False, False)],
               "inv": [(True, True), (True, False)]}
BUSY_CHAIN, BUSY_BATCH = 5, 256
SWEEP_LOG_NS, SWEEP_BATCHES = range(12, 21), (1, 64)
SCALING_LOG_N, SCALING_BATCH = 20, 2
STREAM_BATCHES, STREAM_B = 8, 16
OUT_DIR = "build/chip_smoke"


def _counters():
    """The kernel wrappers' launch counters, by their kernels-line row
    name (the ring layers' per-instantiation counts are
    ring_layers.layered.launches_by)."""
    from ntt_aie_tpu_torch.ops import launch_counters

    return launch_counters()


def _reset_counts():
    from ntt_aie_tpu_torch.ops import reset_launches

    reset_launches()


def _counts():
    from ntt_aie_tpu_torch.ops import read_launches

    return read_launches()


def _run_cli(argv):
    """cli.main(argv) in this process: (exit code, its standard output)."""
    import contextlib
    import io

    from ntt_aie_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _pass_bools(symbol):
    """(kDit, kTranspose) of a column-pass kernel's symbol in a trace."""
    import re

    m = re.search(r"colpass_kernel<(\w+), (\w+)", symbol)
    return None if m is None else tuple(v in ("true", "1")
                                        for v in m.groups())


def cli_phase(dev, card):
    """Phase 34: python -m ntt_aie_tpu_torch info in a subprocess; verify
    (CLI_VERIFY) and bench (CLI_BENCH, fwd / inv / polymul) through
    cli.main, each with the column kernels' counts zeroed just before it.
    Returns the launches by kernel, or None after emitting the failure."""
    import torch

    res = subprocess.run([sys.executable, "-m", "ntt_aie_tpu_torch", "info"],
                         capture_output=True, text=True, timeout=300)
    print(res.stdout, end="", flush=True)
    info_ok = (res.returncode == 0
               and torch.cuda.get_device_name(0) in res.stdout
               and f"devices: {torch.cuda.device_count()}" in res.stdout)
    emit({"phase": "cli", "command": "info", "rc": res.returncode,
          "ok": info_ok})
    if not info_ok:
        fail("cli", "python -m ntt_aie_tpu_torch info failed: "
                    + res.stderr[-2000:])
        return None
    totals = dict.fromkeys(_counters(), 0)
    for argv in CLI_VERIFY:
        _reset_counts()
        rc, out = _run_cli(argv)
        torch.cuda.synchronize()
        counts = _counts()
        print(out, end="", flush=True)
        labels = [ln.strip() for ln in out.splitlines()
                  if ln.strip().startswith("[")]
        ok = rc == 0 and out.rstrip().endswith("PASS!") and all(
            ln.startswith("[PASS]") for ln in labels)
        emit({"phase": "cli", "command": " ".join(argv), "rc": rc,
              "labels": labels, "launches": counts, "ok": ok})
        if not ok:
            fail("cli", f"{' '.join(argv)} did not pass")
            return None
        for k, v in counts.items():
            totals[k] += v
    for field, log_n, B in CLI_BENCH:
        for op in ("fwd", "inv", "polymul"):
            argv = ["bench", "--field", field, "--log-n", str(log_n),
                    "--batch", str(B), "--op", op, *CLI_BENCH_ITERS]
            if op == "fwd":  # the measured denominators of the arithmetic
                argv.append("--calibrate")
            _reset_counts()
            rc, out = _run_cli(argv)
            torch.cuda.synchronize()
            counts = _counts()
            print(out, end="", flush=True)
            rep = json.loads(out.strip().splitlines()[-1])
            kern = "gl_colpass" if field == "GOLDILOCKS" else "colpass"
            ok = (rc == 0 and rep.get("verified") is True
                  and rep.get("engine") == "cuda"
                  and rep.get("clock") == "cuda_events" and counts[kern] > 0)
            emit({"phase": "cli", "command": " ".join(argv), "rc": rc,
                  "card": card, "us_per_transform": rep["us_per_transform"],
                  "verified": rep.get("verified"), "launches": counts,
                  **{k: rep[k] for k in ("measured_hbm_gbps",
                                         "measured_vpu_bfly_per_sec",
                                         "vpu_efficiency_measured")
                     if k in rep},
                  "ok": ok})
            if not ok:
                fail("cli", f"{' '.join(argv)}: not verified or no "
                            "kernel launched")
                return None
            for k, v in counts.items():
                totals[k] += v
    return totals


def _sleep_ahead_us(fn, x, *, iters=20, repeats=3, cycles=20_000_000):
    """Device µs a call of fn, the host's enqueue hidden: a chain of
    `iters` calls is enqueued behind a sleep kernel (torch.cuda._sleep,
    ~10 ms at the card's clock) and timed between two CUDA events recorded
    after it. Returns (median µs a call, whether every repeat's enqueue
    finished inside the sleep)."""
    import torch

    fn(x)
    torch.cuda.synchronize()
    runs, hidden = [], True
    for _ in range(repeats):
        e0, start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
        e0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        y = x
        for _ in range(iters):
            y = fn(y)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        hidden = hidden and enqueue_ms < e0.elapsed_time(start)
        runs.append(start.elapsed_time(end) * 1e3 / iters)
    return sorted(runs)[len(runs) // 2], hidden


def trace_phase(dev, card, rng):
    """Phase 35: the CLI's trace at n = 2^TRACE_LOG_N (TRACE_CELLS), each
    summary read back: method 'profiler', the two derived rows naming the
    column passes in program order, each pass's traced time beside
    CUDA-event times of the same pass at B = 1; then capture_trace over a
    chain of BUSY_CHAIN fwd_mat calls at B = BUSY_BATCH and over one B = 1
    fwd, with the traced window, the device time and the busy share.
    Returns the launches by kernel, or None after emitting the failure."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.profiling import trace as TR
    from ntt_aie_tpu_torch.utils.timing import time_device

    totals = dict.fromkeys(_counters(), 0)
    plan = T.build_plan(T.NTTConfig(field=T.P_469762049, log_n=TRACE_LOG_N),
                        device=dev)
    n1, n2 = plan.config.split
    x1 = torch.randint(0, T.P_469762049.p, (1, n1, n2), dtype=torch.int32,
                       device=dev)
    # CUDA events around a chain of each pass (host-bound at B = 1: the
    # wrapper's enqueue is longer than the kernel) and behind a sleep (the
    # device's time alone)
    event_us = {k: time_device(plan.passes[k], x1)["us_per_iter"]
                for k in ("cp1", "cp2", "icp2", "icp1")}
    ahead = {k: _sleep_ahead_us(plan.passes[k], x1)
             for k in ("cp1", "cp2", "icp2", "icp1")}
    for label, op, extra in TRACE_CELLS:
        summary = f"{OUT_DIR}/trace/{label}.json"
        argv = ["trace", "--log-n", str(TRACE_LOG_N), "--op", op, "--out",
                f"{OUT_DIR}/trace/{label}", "--summary-out", summary, *extra]
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            _reset_counts()
            rc, out = _run_cli(argv)
            torch.cuda.synchronize()
            counts = _counts()
            print(out, end="", flush=True)
            if rc != 0:
                fail("trace", f"{' '.join(argv)} exited {rc}")
                return None
            with open(summary) as f:
                payload = json.load(f)
            derived = payload.get("derived", [])
            order = [_pass_bools(r["op"]) for r in derived]
            ok = payload["method"] == "profiler" and counts["colpass"] > 0
            if op in TRACE_ORDER:
                ok = ok and order == TRACE_ORDER[op]
            else:  # polymul: two forward transforms and one inverse
                ok = ok and sum(r["count"] for r in payload["ops"]
                                if _pass_bools(r["op"])) == 6
            if ok:
                break
        names = ("cp1", "cp2") if op == "fwd" else ("icp2", "icp1")
        line = {"phase": "trace", "cell": label, "card": card,
                "method": payload["method"], "launches": counts,
                "ops": [{k: r[k] for k in ("op", "total_us", "count")}
                        for r in payload["ops"][:6]],
                "attempts": attempt, "ok": ok}
        if op in TRACE_ORDER:
            line["passes"] = [
                {"pass": name, "kernel": r["op"], "trace_us": r["us"],
                 "cuda_events_chain_us": (event_us[name] if not extra
                                          else None),
                 "cuda_events_sleep_ahead_us": (ahead[name][0] if not extra
                                                else None),
                 "enqueue_hidden": ahead[name][1] if not extra else None,
                 "gbf_per_sec": r["gbf_per_sec"],
                 "hbm_utilization": r["hbm_utilization"],
                 "vpu_utilization": r["vpu_utilization"], "bound": r["bound"]}
                for name, r in zip(names, derived)]
        emit(line)
        if not ok:
            fail("trace", f"{label}: no profiler rows, or the passes "
                          f"out of order: {order}")
            return None
        for k, v in counts.items():
            totals[k] += v
    # the busy share: a chain of fwd_mat at B = BUSY_BATCH, one B = 1 fwd
    fwd_mat = plan.make_batched(BUSY_BATCH)["fwd_mat"]
    xb = torch.randint(0, T.P_469762049.p, (BUSY_BATCH, n1, n2),
                       dtype=torch.int32, device=dev)

    def chain(call, times):
        def run(v):
            for _ in range(times):
                v = call(v)
            return v
        return run

    for label, fn, x in (
            ("fwd_mat_chain_b256", chain(fwd_mat, BUSY_CHAIN), xb),
            ("fwd_b1", plan.fwd, x1.reshape(-1)),
            ("fwd_b1_chain20", chain(plan.fwd, 20), x1.reshape(-1))):
        _reset_counts()
        d = TR.capture_trace(fn, x, trace_dir=f"{OUT_DIR}/busy/{label}")
        counts = _counts()
        busy = TR.device_busy(d)
        rows = TR.summarize_trace(d)
        kernel_us = sum(r["total_us"] for r in rows if _pass_bools(r["op"]))
        ok = busy["device_events"] > 0 and counts["colpass"] > 0
        emit({"phase": "trace_busy", "cell": label, "card": card,
              "window_us": busy["window_us"], "device_us": busy["device_us"],
              "kernel_sum_us": busy["kernel_sum_us"],
              "colpass_us": kernel_us, "busy_share": busy["busy_share"],
              "launches": counts, "ok": ok,
              "note": "window: the traced call's first event to its last "
                      "(host ops, launches and the closing synchronize); "
                      "device_us: the union of kernel, memcpy and memset "
                      "intervals"})
        if not ok:
            fail("trace", f"{label}: the trace holds no device "
                          "event")
            return None
        for k, v in counts.items():
            totals[k] += v
    return totals


def sweep_phase(dev, card):
    """Phase 36: run_sweep over SWEEP_LOG_NS x SWEEP_BATCHES with its CSVs
    under OUT_DIR/sweep. Returns the launches, or None after the
    failure."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.profiling.sweep import run_sweep

    t0 = time.perf_counter()
    _reset_counts()
    rows = run_sweep(T.P_469762049, SWEEP_LOG_NS, SWEEP_BATCHES,
                     out_dir=f"{OUT_DIR}/sweep", device=dev)
    torch.cuda.synchronize()
    counts = _counts()
    ok = (len(rows) == len(SWEEP_LOG_NS) * len(SWEEP_BATCHES)
          and counts["colpass"] > 0
          and all(r["clock"] == "cuda_events" for r in rows))
    emit({"phase": "sweep", "card": card, "seconds": time.perf_counter() - t0,
          "rows": [{k: v for k, v in r.items() if k != "runs_us"}
                   for r in rows], "launches": counts, "ok": ok})
    if not ok:
        fail("sweep", "the sweep is incomplete or launched no "
                      "kernel")
        return None
    return counts


def scaling_phase(dev, card):
    """Phase 37: run_scaling at D = 1, 2 with gloo on the card (D = 2: two
    ranks that share it, never a multi-chip figure), then the NCCL request
    at D = 1, 2 (D = 2 skipped with a printed line where the machine has
    one card). Returns the launches (summed over the ranks), or None."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.profiling.scaling import run_scaling

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    rows = []
    for backend in ("gloo", "nccl"):
        rows += run_scaling(T.P_469762049, SCALING_LOG_N, (1, 2),
                            batch=SCALING_BATCH, iters=3, repeats=3,
                            device=dev, backend=backend)
    want = [("gloo", 1), ("gloo", 2), ("nccl", 1)] + (
        [("nccl", 2)] if cards >= 2 else [])
    ok = ([(r["backend"], r["devices"]) for r in rows] == want
          and all(r["launches"] > 0 for r in rows)
          and all(r["placement"] == ("ranks share one card"
                                     if r["devices"] > cards
                                     else "a card a rank") for r in rows))
    for r in rows:
        emit(dict(r, phase="scaling", card=card,
                  note=("not a multi-chip figure: the ranks share one card "
                        "and gloo stages the collective through the host")
                  if r["placement"] == "ranks share one card" else None))
    emit({"phase": "scaling_done", "seconds": time.perf_counter() - t0,
          "ok": ok})
    if not ok:
        fail("scaling", "missing rows, a wrong placement or no "
                        "kernel launched")
        return None
    return {"colpass": sum(r["launches"] for r in rows), "gl_colpass": 0}


def stream_phase(dev, card, rng):
    """Phase 38: stream_transform over STREAM_BATCHES host batches of
    fwd_mat at n = 2^20, B = STREAM_B: every output equal to a direct call
    on the card; the streamed time (prefetch 2) beside a serial loop
    (pageable upload, compute, download, one batch at a time) and beside
    the same pinned pipeline at prefetch 1 (no overlap), in turns, with
    the parts of the serial loop alone. Returns the launches, or None
    after the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.utils.streaming import stream_transform

    plan = T.build_plan(T.NTTConfig(field=T.P_469762049, log_n=20),
                        device=dev)
    n1, n2 = plan.config.split
    fwd_mat = plan.make_batched(STREAM_B)["fwd_mat"]
    batches = [rng.integers(0, T.P_469762049.p, (STREAM_B, n1, n2))
               .astype(np.uint32) for _ in range(STREAM_BATCHES)]
    _reset_counts()
    got = list(stream_transform(fwd_mat, batches))
    torch.cuda.synchronize()
    counts = _counts()
    equal = all(np.array_equal(
        y, fwd_mat(torch.from_numpy(x.view(np.int32)).to(dev)).cpu().numpy()
        .view(np.uint32)) for x, y in zip(batches, got))
    del got

    def serial():
        return [fwd_mat(torch.from_numpy(x.view(np.int32)).to(dev)).cpu()
                .numpy() for x in batches]

    def streamed():
        return list(stream_transform(fwd_mat, batches))

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def prefetch1():  # the same pinned pipeline, one batch at a time
        return list(stream_transform(fwd_mat, batches, prefetch=1))

    serial()  # warm-up of the pageable path
    runs = {"serial": serial, "streamed": streamed, "prefetch1": prefetch1}
    times = {name: [] for name in runs}
    for name in ("serial", "streamed", "prefetch1", "prefetch1", "streamed",
                 "serial"):
        times[name].append(wall(runs[name]))
    # the serial loop's parts, one batch at a time
    xs = [torch.from_numpy(x.view(np.int32)) for x in batches]
    up = wall(lambda: [x.to(dev) for x in xs]) / STREAM_BATCHES
    xd = xs[0].to(dev)
    compute = wall(lambda: [fwd_mat(xd) for _ in batches]) / STREAM_BATCHES
    yd = fwd_mat(xd)
    down = wall(lambda: [yd.cpu() for _ in batches]) / STREAM_BATCHES
    ser = min(times["serial"])
    st = min(times["streamed"])
    one = min(times["prefetch1"])
    ok = equal and counts["colpass"] == 2 * STREAM_BATCHES
    emit({"phase": "stream", "card": card, "batches": STREAM_BATCHES,
          "batch": STREAM_B, "n": n1 * n2, "equal": equal,
          "launches": counts, "serial_ms": times["serial"],
          "streamed_ms": times["streamed"],
          "prefetch1_ms": times["prefetch1"],
          "overlap_saved_share": 1 - st / one,
          "per_batch_ms": {"upload": up, "compute": compute,
                           "download": down},
          "serial_over_streamed": ser / st,
          "time_saved_share": 1 - st / ser,
          "bytes_per_batch": STREAM_B * n1 * n2 * 4, "ok": ok})
    if not ok:
        fail("stream", "streamed outputs differ from direct calls or "
                       "the launches are off")
        return None
    return counts


def entry_point_phases(args, dev, card, rng):
    """Phases 34-38. Returns the column kernels' launches of each phase's
    driven calls {kernel: {phase: count}}, or None after the failure."""
    import torch

    out = {}
    for name, run in (("cli", lambda: cli_phase(dev, card)),
                      ("trace", lambda: trace_phase(dev, card, rng)),
                      ("sweep", lambda: sweep_phase(dev, card)),
                      ("scaling", lambda: scaling_phase(dev, card)),
                      ("stream", lambda: stream_phase(dev, card, rng))):
        counts = run()
        if counts is None:
            return None
        for kern, v in counts.items():
            out.setdefault(kern, {})[name] = v
        torch.cuda.empty_cache()
    return out


# Phase 39: the worked examples (ntt_aie_tpu_torch/examples), each
# example's run() on the card at the sizes listed ((example, keyword
# arguments)): the reference's sizes, the largest flat single-shard ring
# (rlwe 2^16), 2^20-bit integers (n = 2^17, four-step), the main path's
# n = 2^20, B = 256 (matform, its rows gated here on the native oracle),
# and the distributed demo at its default world and at four gloo ranks
# that share the card (the hierarchical branch; not a multi-chip figure).
EXAMPLE_MODULES = {"rlwe": "rlwe_demo", "bigint": "bigint_multiply",
                   "matform": "serving_matform_demo",
                   "pqc": "pqc_serving_demo",
                   "distributed": "distributed_demo"}
EXAMPLE_RUNS = (("rlwe", {"log_n": 10}), ("rlwe", {"log_n": 16}),
                ("bigint", {"bits": 4096}), ("bigint", {"bits": 1 << 20}),
                ("matform", {"log_n": 12, "batch": 4}),
                ("matform", {"log_n": 20, "batch": 256, "oracle_rows": ()}),
                ("pqc", {"batch": 64}), ("pqc", {"batch": 1024}),
                ("distributed", {}),
                ("distributed", {"world": 4, "backend": "gloo"}))
# the kernels each example must launch (its kernels-line rows)
EXAMPLE_KERNELS = {"rlwe": ("fused_fourstep", "pointwise32"),
                   "bigint": ("colpass", "crt", "pointwise32"),
                   "matform": ("colpass", "pointwise32"),
                   "pqc": ("ring_layers",),
                   "distributed": ("colpass", "fused_fourstep", "crt",
                                   "pointwise32")}
# the pqc example's ring-kernel launches a run, by instantiation: each
# scheme's serving_step with a batch of matrices one fused launch, ML-KEM's
# fixed-A step the key's transform and one fused launch
EXAMPLE_RING_LAUNCHES = {"kyber_serve_fresh": 1, "dilithium_serve_fresh": 1,
                         "kyber_ntt": 1, "kyber_serve": 1}
EXAMPLE_ORACLE_ROWS = 8  # random rows beside row 0 at the main path's size
EXAMPLE_TIME_ITERS, EXAMPLE_TIME_REPEATS = 5, 5


def _matform_native_gate(out, rng):
    """Row 0 and EXAMPLE_ORACLE_ROWS random rows of the matrix-form
    example's output against the native oracle's cyclic product."""
    import numpy as np

    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch.fields import P_469762049 as field

    B, n = out["out"].shape
    rows = [0] + sorted(int(r) for r in rng.choice(
        np.arange(1, B), size=min(EXAMPLE_ORACLE_ROWS, B - 1),
        replace=False))
    got = out["out"][rows].cpu().numpy().astype(np.uint64)
    omega = field.root_of_unity(n)
    return rows, all(np.array_equal(
        got[i], native_oracle.cyclic_polymul(out["msgs"][r], out["kern"][r],
                                             omega, field.p))
        for i, r in enumerate(rows))


def _matform_turns(out, dev):
    """us per NTT-product of one B-row request through the example's
    cached loop and through polymul_mat, and of the loop's two parts alone
    (fwd_mat, the pointwise product against the cached spectra), in turns
    on CUDA events (each in the order of TURNS and then back), each
    reading time_device's trimmed mean over a dependent chain."""
    import numpy as np
    import torch

    from ntt_aie_tpu_torch.examples import serving_matform_demo as SM
    from ntt_aie_tpu_torch.utils.timing import time_device

    ctx, k_spec = out["context"], out["k_spec"]
    B, (n1, n2) = out["batch"], out["split"]
    bat = ctx.make_batched(B)
    m2d, k2d = (torch.from_numpy(v.reshape(B, n1, n2).view(np.int32)).to(dev)
                for v in (out["msgs"], out["kern"]))
    fns = {"cached_loop": lambda x: SM.serve(bat, ctx.plan.pointwise,
                                             k_spec, x),
           "polymul_mat": lambda x: bat["polymul_mat"](x, k2d),
           "fwd_mat": bat["fwd_mat"],
           "pointwise": lambda x: ctx.plan.pointwise(x, k_spec)}
    turns = tuple(fns)
    runs = {k: [] for k in fns}
    for k in turns + turns[::-1]:
        runs[k].append(time_device(fns[k], m2d, iters=EXAMPLE_TIME_ITERS,
                                   repeats=EXAMPLE_TIME_REPEATS)
                       ["us_per_iter"] / B)
    us = {k: sum(v) / len(v) for k, v in runs.items()}
    return {"us_per_product": us, "readings": runs,
            "loop_over_polymul_mat": us["cached_loop"] / us["polymul_mat"]}


def examples_phase(dev, card, rng):
    """Phase 39: each example's run() on the card (EXAMPLE_RUNS), its
    checks its own (AssertionError fails the phase), its kernels' launches
    counted from 0 just before the run (the distributed demo's in its
    ranks, summed), each of EXAMPLE_KERNELS[example] launched; matform at
    n = 2^20 also gated on the native oracle and timed against
    polymul_mat. Returns the launches by kernels-line row name, summed
    over the runs, or None after the failure."""
    import importlib

    import torch

    from ntt_aie_tpu_torch.ops import ring_layers as LR

    t_phase = time.perf_counter()
    totals = {}
    for name, kw in EXAMPLE_RUNS:
        mod = importlib.import_module(
            f"ntt_aie_tpu_torch.examples.{EXAMPLE_MODULES[name]}")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        try:
            out = mod.run(**kw)
        except AssertionError as e:
            fail("examples", f"{name} {kw}: {e}")
            return None
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # the distributed demo's launches are counted in its spawned ranks
        got = out["launches"] if name == "distributed" else _counts()
        counts = {k: v for k, v in got.items() if v}
        by_key = dict(LR.layered.launches_by)
        line = {"phase": "examples", "example": name,
                "module": f"ntt_aie_tpu_torch.examples.{EXAMPLE_MODULES[name]}",
                "sizes": {k: v for k, v in kw.items() if k != "oracle_rows"},
                "seconds": seconds, "launches": counts,
                "ring_layers_by": by_key, "lines": out["lines"]}
        if name == "distributed":
            line.update(world=out["world"], backend=out["backend"])
            if out["backend"] == "gloo" and out["world"] > 1:
                line["note"] = ("ranks share one card (gloo staged through "
                                "the host): not a multi-chip figure")
        ok = all(counts.get(k) for k in EXAMPLE_KERNELS[name])
        if name == "pqc":
            line["ring_layers_expected"] = EXAMPLE_RING_LAUNCHES
            ok = ok and by_key == EXAMPLE_RING_LAUNCHES
        if name == "matform" and kw["log_n"] == 20:
            rows, gate = _matform_native_gate(out, rng)
            line.update(native_rows=rows, native_oracle=gate, card=card,
                        **_matform_turns(out, dev))
            ok = ok and gate
        line["ok"] = ok
        emit(line)
        if not ok:
            fail("examples", f"{name} {kw}: a check failed or a listed "
                 f"kernel ({', '.join(EXAMPLE_KERNELS[name])}) did not "
                 "launch as expected")
            return None
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for k, v in by_key.items():
            key = f"ring_layers[{k}]"
            totals[key] = totals.get(key, 0) + v
        del out
        torch.cuda.empty_cache()
    emit({"phase": "examples_done", "seconds": time.perf_counter() - t_phase,
          "launches": totals, "ok": True})
    return totals


# Phase 40: the tall route (a column pass above one launch's rows as two
# launches, ops/colpass.py tall_phases: 32-bit above 4,096 rows, Goldilocks
# above 2,048) on the largest transforms of BabyBear and Goldilocks,
# through build_plan and make_batched(1) at their default splits: (label,
# field name, log_n, plan keywords, PERF.md row, dropped when its set-up
# passes TALL_SETUP_LIMIT_S, the callables whose row 0 the native oracle
# gates, in worker threads from the case's start). BabyBear and Goldilocks
# at 2^27 run 8192 x 16384 (every pass tall); Goldilocks at 2^28 runs
# 16384 x 16384 on the factored arm (no n1 x n2 host matrix); Goldilocks
# at 2^24 runs 4096 x 4096 (every pass tall).
TALL_CASES = (("babybear", "p2013265921", 27, {}, "1t", False,
               ("fwd_mat",)),
              ("goldilocks", "goldilocks", 27, {}, "3t", False, ()),
              ("goldilocks_factored", "goldilocks", 28,
               {"wmat_factored": True}, "3t", True, ()),
              ("goldilocks_2^24", "goldilocks", 24, {}, "3t", False,
               ("fwd_mat", "polymul_mat")))
TALL_SETUP_LIMIT_S = 60.0
# the plain versions run on 2^TALL_PLAIN_LOG-point column slices: at 2^28
# their int64 carriers would not fit the card's 80 GB at once
TALL_PLAIN_LOG = 26
# each call's passes, in order (polymul_mat: both operands' fwd, the
# pointwise product, inv)
TALL_CALL_PASSES = {"fwd_mat": ("cp1", "cp2"), "inv_mat": ("icp2", "icp1"),
                    "polymul_mat": ("cp1", "cp2", "cp1", "cp2", "icp2",
                                    "icp1")}


def _tall_ops(gl):
    """The column-pass module's entry points a tall pass is checked
    through: its phase launch, the phase's plain version, the whole pass's
    plain version, kernel_info, the wrapper and its kernels-line row."""
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G

    if gl:
        return dict(phase=G.gl_colpass_phase, phase_plain=G.gl_tall_phase_plain,
                    plain=G.gl_colpass_plain, info=G.kernel_info,
                    counter=G.gl_colpass, name="gl_colpass", itemsize=8,
                    source="ntt_aie_tpu_torch/csrc/gl_colpass.cu",
                    replaces="ntt_aie_tpu/ops/pallas_gl.py:33")
    return dict(phase=C.colpass_phase, phase_plain=C.tall_phase_plain,
                plain=C.colpass_plain, info=C.kernel_info, counter=C.colpass,
                name="colpass", itemsize=4,
                source="ntt_aie_tpu_torch/csrc/colpass.cu",
                replaces="ntt_aie_tpu/ops/pallas_ntt.py:298")


def _max_err(a, b) -> int:
    """The largest absolute difference between two outputs' words (int32
    tensors or (hi, lo) planes), as uint32 bit patterns."""
    pa = a if isinstance(a, tuple) else (a,)
    pb = b if isinstance(b, tuple) else (b,)
    return max(int(((u.long() & 0xFFFFFFFF) - (w.long() & 0xFFFFFFFF))
                   .abs().max()) for u, w in zip(pa, pb))


def _tall_input(field, shape, dev, gen):
    """Canonical values of field drawn on the card: an int32 tensor, or
    Goldilocks (hi, lo) planes with hi < 2^32 - 1 (so below p)."""
    import torch

    def draw(top):
        return torch.randint(0, top, shape, dtype=torch.int64, device=dev,
                             generator=gen).to(torch.int32)

    if field.is_goldilocks:
        return draw((1 << 32) - 1), draw(1 << 32)
    return draw(field.p)


def _tall_oracle(key, field, a, b):
    """Row 0 of a plan's callable `key` on the native oracle (the NumPy
    one where the library cannot build), from row 0 of its inputs a and b
    (uint64): fwd_mat's spectrum in natural order, or polymul_mat's cyclic
    product. Returns (values, oracle name)."""
    import numpy as np

    from ntt_aie_tpu_torch import native_oracle, reference
    from ntt_aie_tpu_torch import twiddles as tw

    n = len(a)
    w = field.root_of_unity(n)
    try:
        if key == "fwd_mat":
            return (native_oracle.ntt_dif(a, w, field.p)[
                tw.bit_reverse_indices(n)], "native")
        return native_oracle.cyclic_polymul(a, b, w, field.p), "native"
    except (native_oracle.NativeOracleUnavailable, OSError):
        want = (reference.ntt_forward(a, field) if key == "fwd_mat"
                else reference.cyclic_polymul(a, b, field))
        return np.asarray(want, np.uint64), "numpy"


def _column_slice(cp, cols):
    """cp (a ColPass or a GLColPass) over the columns `cols` of its
    array: a column's pass reads only its own column of each operand."""
    import dataclasses

    cut = {}
    if cp.pre is not None:
        cut["pre"] = cp.pre[:, cols]
    if cp.post is not None:
        cut["post"] = cp.post[:, cols]
    if cp.wmat is not None:
        cut["wmat"] = cp.wmat[cols]
    if cp.wfac is not None:
        cut["wfac"] = tuple(t[:, cols].contiguous() for t in cp.wfac)
    if cp.rank1 is not None:
        cut["rank1"] = (cp.rank1[0], cp.rank1[1][cols])
    return dataclasses.replace(cp, **cut)


def _by_columns(fn, v, cp, chunks, transposed, *args):
    """fn(v, cp, *args), a plain version, over `chunks` slices of v's
    columns, joined (the output's rows where transposed): the plain
    versions' int64 carriers of a 2^28-point array would not fit the
    card at once."""
    import torch

    planes = v if isinstance(v, tuple) else (v,)
    ncols = planes[0].shape[-1]
    step = max(1, ncols // chunks)
    parts = []
    for c0 in range(0, ncols, step):
        cols = slice(c0, c0 + step)
        part = tuple(t[..., cols].contiguous() for t in planes)
        out = fn(part if isinstance(v, tuple) else part[0],
                 _column_slice(cp, cols), *args)
        parts.append(out if isinstance(out, tuple) else (out,))
    dim = -2 if transposed else -1
    joined = tuple(torch.cat(ps, dim=dim) for ps in zip(*parts))
    return joined if isinstance(v, tuple) else joined[0]


def _table_bytes(cp, phase=None) -> int:
    """The bytes of the tables a launch of cp's tall route reads once
    (phase 'A': the mid vector and the 'pre' operands; 'B': the 'post'
    and 'post_t' ones; None: the whole pass's)."""
    def at(pos):
        return ([cp.pre if pos == "pre" else cp.post]
                + list(cp.wfac or () if cp.wfac_pos == pos else ())
                + list(cp.rank1 or () if cp.rank1_pos == pos else ()))

    tabs = {"A": [cp.wmid] + at("pre"), "B": at("post") + [cp.wmat],
            None: [cp.wmid, cp.wmat] + at("pre") + at("post")}[phase]
    return sum(t.numel() * t.element_size() for t in tabs if t is not None)


def _tall_case(spec, dev, card, gen):
    """One TALL_CASES plan at B = 1: set-up; fwd_mat, inv_mat and
    polymul_mat with launches counted from 0 just before each call and
    read just after, equal to the passes' instantiations (a tall pass's
    two keys); every tall launch on the path's own input against its
    plain version, raw, and the two against the whole pass's plain
    version; fwd_mat and polymul_mat against the plain passes' chain on
    the card, and where the spec asks, row 0 on the native oracle; the
    round trip; µs a call and ms a launch on CUDA events; kernel_info of every
    pass (each launch's rows, tile columns, registers, blocks an SM).
    Returns (its line, its kernels-line rows), ([], []) when dropped, or
    None after the failure."""
    import concurrent.futures

    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    label, name, log_n, kw, perf_row, optional, native = spec
    field = T.FIELDS[name]
    gl = field.is_goldilocks
    ops = _tall_ops(gl)
    cfg = T.NTTConfig(field=field, log_n=log_n)
    n, (n1, n2) = cfg.n, cfg.split
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = T.build_plan(cfg, device=dev, **kw)
    bat = plan.make_batched(1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    line = {"phase": "tall", "case": label, "field": name, "n": n,
            "split": [n1, n2], "batch": 1, "plan": kw, "card": card,
            "reduction": plan.reduction, "setup_s": setup_s}
    if optional and setup_s > TALL_SETUP_LIMIT_S:
        emit(dict(line, ok=True, dropped=f"set-up took {setup_s:.1f} s, "
                  f"above {TALL_SETUP_LIMIT_S:.0f} s: not run"))
        return [], []
    passes = {k: plan.passes[k] for k in ("cp1", "cp2", "icp2", "icp1")}
    tall = [k for k, cp in passes.items() if cp.tall is not None]
    x = _tall_input(field, (1, n1, n2), dev, gen)
    y = _tall_input(field, (1, n1, n2), dev, gen)

    def host_row(v):
        """Row 0 of a (1, ...) array as uint64 values, flat."""
        if gl:
            return M.gl_to_u64(*(t.reshape(n) for t in v))
        return v.reshape(n).cpu().numpy().astype(np.uint64)

    # the native oracle's rows, in worker threads beside the card's work
    pool = concurrent.futures.ThreadPoolExecutor(2)
    oracle = {key: pool.submit(_tall_oracle, key, field, host_row(x),
                               host_row(y)) for key in native}
    pool.shutdown(wait=False)

    # the main path, each call's launches counted from 0
    by, outs = {}, {}
    for key in TALL_CALL_PASSES:
        args = {"fwd_mat": (x,), "inv_mat": (outs.get("fwd_mat"),),
                "polymul_mat": (x, y)}[key]
        torch.cuda.synchronize()
        _reset_counts()
        G.gl_mul.launches = 0
        outs[key] = bat[key](*args)
        torch.cuda.synchronize()
        by[key] = dict(ops["counter"].launches_by)
        if gl and key == "polymul_mat":
            by[key]["gl_mul"] = G.gl_mul.launches
    want_by = {}
    for key, names in TALL_CALL_PASSES.items():
        want = want_by.setdefault(key, {})
        for k in names:
            cp = passes[k]
            for v in ([C.variant(cp, ph) for ph in "AB"]
                      if cp.tall is not None else [C.variant(cp)]):
                want[v] = want.get(v, 0) + 1
    if gl:
        want_by["polymul_mat"]["gl_mul"] = 1
    counts_ok = by == want_by

    # every tall launch on the path's own input against its plain version
    # (timed by CUDA events around that one call), the two against the
    # whole pass's plain version (the plain chain's output)
    chunks = max(1, n >> TALL_PLAIN_LOG)

    def pointwise(a, b):
        if not gl:
            return plan.pointwise(a, b)
        return tuple(torch.cat(ps, dim=-1) for ps in zip(*(
            G.gl_mul_plain(tuple(t[..., c] for t in a),
                           tuple(t[..., c] for t in b))
            for c in torch.arange(a[0].shape[-1], device=dev).chunk(chunks))))

    def run_plain(k, v):
        cp = passes[k]
        return _by_columns(ops["plain"], v, cp, chunks, cp.transpose_out)

    def phase_plain(v, cp, ph):
        return _by_columns(ops["phase_plain"], v, cp, chunks,
                           ph == "B" and cp.transpose_out, ph)

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    f1 = run_plain("cp1", x)
    plain_fwd = run_plain("cp2", f1)
    i2 = run_plain("icp2", outs["fwd_mat"])
    inputs = {"cp1": x, "cp2": f1, "icp2": outs["fwd_mat"], "icp1": i2}
    wholes = {"cp1": f1, "cp2": plain_fwd, "icp2": i2}
    errs, launch_ms, plain_ms, infos, pass_equal = {}, {}, {}, {}, {}
    for k in tall:
        cp, v = passes[k], inputs[k]
        a = ops["phase"](v, cp, "A")
        torch.cuda.synchronize()
        want_a, plain_ms[f"{k}A"] = timed(phase_plain, v, cp, "A")
        b = ops["phase"](a, cp, "B")
        torch.cuda.synchronize()
        want_b, plain_ms[f"{k}B"] = timed(phase_plain, a, cp, "B")
        whole = wholes[k] if k in wholes else run_plain(k, v)
        errs[k] = {"A": _max_err(a, want_a), "B": _max_err(b, want_b),
                   "pass": _max_err(b, whole)}
        pass_equal[k] = not any(errs[k].values())
        del want_a, want_b, whole
        for ph, u in (("A", v), ("B", a)):
            launch_ms[f"{k}{ph}"] = time_device(
                lambda _, u=u, ph=ph, cp=cp: ops["phase"](u, cp, ph), u,
                iters=5, repeats=3)["us_per_iter"] / 1e3
        del a, b
        torch.cuda.empty_cache()
    infos = {k: ops["info"](cp, n2 if k in ("cp1", "icp1") else n1)
             for k, cp in passes.items()}

    # the gates: fwd_mat and polymul_mat against the plain chain and, where
    # the spec asks, row 0 on the native oracle; the round trip
    y_fwd = outs["fwd_mat"]
    fb = run_plain("cp2", run_plain("cp1", y))
    prod = run_plain("icp1", run_plain("icp2", pointwise(plain_fwd, fb)))
    polymul_ok = _max_err(outs["polymul_mat"], prod) == 0
    gate_ok = _max_err(y_fwd, plain_fwd) == 0
    gates = {"fwd_mat": host_row(y_fwd)[plan.spectral_to_natural]
             if "fwd_mat" in native else None,
             "polymul_mat": host_row(outs["polymul_mat"])
             if "polymul_mat" in native else None}
    oracles = {}
    for key, fut in oracle.items():
        want, oracles[key] = fut.result()
        ok_key = bool(np.array_equal(gates[key], want))
        if key == "fwd_mat":
            gate_ok = gate_ok and ok_key
        else:
            polymul_ok = polymul_ok and ok_key
    gate = oracles.get("fwd_mat", "plain passes on the card")
    del gates, oracle
    roundtrip_ok = _max_err(outs["inv_mat"], x) == 0
    del fb, prod, f1, i2, plain_fwd, inputs, wholes
    torch.cuda.empty_cache()

    # µs a call on CUDA events (each call on the same inputs)
    call_us = {key: time_device(
        lambda _, key=key: bat[key](*({"fwd_mat": (x,),
                                       "inv_mat": (y_fwd,),
                                       "polymul_mat": (x, y)}[key])),
        x, iters=3, repeats=3)["us_per_iter"] for key in TALL_CALL_PASSES}

    ok = bool(counts_ok and gate_ok and roundtrip_ok and polymul_ok
              and all(pass_equal.values()))
    line.update({"tall_passes": tall, "launches_by": by,
                 "launches_ok": counts_ok, "launch_max_abs_err": errs,
                 "oracle": gate, "oracles": oracles, "gate_ok": gate_ok,
                 "roundtrip_ok": roundtrip_ok, "polymul_ok": polymul_ok,
                 "us_per_call": call_us, "launch_ms": launch_ms,
                 "plain_launch_ms": plain_ms, "kernel_info": infos,
                 "plain_chunks": chunks,
                 "method": "CUDA events (utils/timing.time_device), each "
                           "call on the same inputs: calls 3 repeats of "
                           "3, a launch 3 of 5, trimmed mean; a plain "
                           "launch one reading, its check's own call, over "
                           "plain_chunks column slices",
                 "ok": ok})
    emit(line)
    if not ok:
        fail("tall", f"{label}: a tall launch, a gate or the launch counts "
             "failed")
        return None

    rows = []
    arithmetic = "goldilocks" if gl else plan.reduction
    item = ops["itemsize"]
    for k in tall:
        cp = passes[k]
        ncols = n2 if k in ("cp1", "icp1") else n1
        pass_bytes = 2 * n * item + _table_bytes(cp)
        pass_bfly = n // 2 * (cp.nn.bit_length() - 1)
        for ph, info in zip("AB", infos[k]["phases"]):
            key = C.variant(cp, ph)
            stages = len(cp.tall["AB".index(ph)].ts)
            rows.append({
                "name": f"{ops['name']}[tall:{label}:{k}{ph}]",
                "perf_row": perf_row, "route": "cuda",
                "source": ops["source"], "replaces": ops["replaces"],
                "variant": key,
                "launches": sum(v.get(key, 0) for v in by.values()),
                "max_abs_err": errs[k][ph], "ms": launch_ms[f"{k}{ph}"],
                "plain_ms": plain_ms[f"{k}{ph}"], "batch": 1,
                "plain_batch": 1, "n": n, "split": [n1, n2],
                "bytes": 2 * n * item + _table_bytes(cp, ph),
                "butterflies": n // 2 * stages, "arithmetic": arithmetic,
                "tile_cols": info["tile_cols"],
                "registers": info["registers"],
                "blocks_per_sm": info["blocks_per_sm"],
                "pass_bytes": pass_bytes, "pass_butterflies": pass_bfly})
    return line, rows


def tall_phase(dev, card, gen):
    """Phase 40: TALL_CASES (_tall_case), each pass's pass bound beside its
    launches' own (the pass reads and writes its array once; its two
    launches each do). Returns the kernels-line rows, or None after the
    failure."""
    import torch

    rows = []
    for spec in TALL_CASES:
        got = _tall_case(spec, dev, card, gen)
        if got is None:
            return None
        rows += got[1]
        torch.cuda.empty_cache()
    emit({"phase": "tall_done", "ok": True, "rows": len(rows)})
    return rows



# Phase 41: every split the JAX package computes, on the card (a column of
# one row: a pass of zero stages; a Goldilocks column of 2 to 8 rows: the
# short kernel; the fused plan's sides above 4,096 rows: its step list; a
# tall phase above one launch's rows: two launches split by stage
# group). (label, field name, log_n, rows_log2 (None: the default split),
# plan keywords, negacyclic, batch, callables, PERF.md row, whether its
# fwd_mat is timed in turns with the fold plan's.) The largest first, so
# their oracles' threads run beside the others; cases of one field, n and
# batch share their inputs and oracle rows.
_MAT3 = ("fwd_mat", "inv_mat", "polymul_mat")
_EVERY = ("fwd", "inv", "polymul", "negacyclic_polymul", "fwd_mat",
          "inv_mat", "polymul_mat", "negacyclic_polymul_mat")
SPLIT_CASES = (
    ("gl_2x2^27", "goldilocks", 28, 1, {"wmat_factored": True}, False, 1,
     _MAT3, "3t", False),
    ("gl_8x2^17", "goldilocks", 20, 3, {}, False, 1, _MAT3, "3t", False),
    ("babybear_one_row", "p2013265921", 27, 0, {}, False, 1, _MAT3, "1t",
     False),
    ("fused_babybear_one_row", "p2013265921", 27, 0, {"fused": True}, False,
     1, _MAT3, "2t", False),
    ("fused_babybear", "p2013265921", 27, None, {"fused": True}, False, 1,
     _MAT3, "2t", True),
    ("one_row", "p469762049", 20, 0, {}, True, 1,
     _MAT3 + ("negacyclic_polymul_mat",), "1s", False),
    ("one_row_fused", "p469762049", 20, 0, {"fused": True}, True, 1,
     _MAT3 + ("negacyclic_polymul_mat",), "2t", True),
    ("gl_one_row", "goldilocks", 16, 0, {}, False, 1, _MAT3, "3s", False),
    ("fused_8x16384", "p2013265921", 17, 3, {"fused": True}, True, 2,
     _EVERY, "2t", True),
    ("fused_16384x8", "p2013265921", 17, 14, {"fused": True}, True, 2,
     _EVERY, "2t", True),
)
# each plan's chains: the forward and inverse transforms' passes (or fused
# transforms), and the negacyclic product's; a callable runs fwd (fwd_mat,
# fwd), inv, or two of fwd then inv (polymul, negacyclic with nfwd, ninv)
SPLIT_CHAINS = {
    "fold": {"fwd": ("cp1", "cp2"), "inv": ("icp2", "icp1"),
             "nfwd": ("ncp1", "cp2"), "ninv": ("icp2", "nicp1")},
    "fused": {"fwd": ("ff",), "inv": ("fi",), "nfwd": ("nf",),
              "ninv": ("ni",)}}


def _split_chains(key: str) -> tuple:
    """The chains a callable runs, in order."""
    base = key[:-4] if key.endswith("_mat") else key
    return {"fwd": ("fwd",), "inv": ("inv",),
            "polymul": ("fwd", "fwd", "inv"),
            "negacyclic_polymul": ("nfwd", "nfwd", "ninv")}[base]


def _split_keys(cp):
    """The launches_by keys of one pass of cp, in order."""
    from ntt_aie_tpu_torch.ops import colpass as C

    suffixes = C.launch_keys(cp)
    return ([C.variant(cp, s) for s in suffixes] if suffixes
            else [C.variant(cp)])


def _launch_bytes(launch, item):
    """The bytes of the operand tables a column-pass launch reads once."""
    from ntt_aie_tpu_torch.ops import colpass as C

    tabs = [launch[k] for k in ("pre", "pre2", "post", "post2", "mat")]
    if launch["tall"] == C.TALL_A:
        tabs.append(launch["mid"])
    return sum(t.numel() * t.element_size() for t in tabs if t is not None)


def _split_oracle(field, row):
    """The forward transform of one row (natural in, bit-reversed out) on
    the native oracle (the NumPy one where the library cannot build):
    (values, oracle name)."""
    import numpy as np

    from ntt_aie_tpu_torch import native_oracle, reference
    from ntt_aie_tpu_torch import twiddles as tw

    n = len(row)
    try:
        want = native_oracle.ntt_dif_batch(
            row[None], field.root_of_unity(n), field.p)[0]
        return want[tw.bit_reverse_indices(n)], "native"
    except (native_oracle.NativeOracleUnavailable, OSError):
        return np.asarray(reference.ntt_forward(row, field),
                          np.uint64), "numpy"


def _split_case(spec, dev, card, gen, pool, shared):
    """One SPLIT_CASES plan: set-up; each callable driven once with the
    launches counted from 0 just before it and read just after, equal to
    its passes' launches (a tall pass's every launch, a fused transform's
    one under its step list's key); every column-pass launch on the path's
    own input against its plain version raw (column slices) and the
    launches against the whole pass's plain version, every fused transform
    against fused_fourstep_plain; each callable against the plain passes'
    chain; fwd on the native oracle (row 0, and row 1 at B = 2: in worker
    threads from the case's start, beside its set-up and the card's
    work); the round trip; ms a launch or a
    fused call on CUDA events; where the spec asks, fwd_mat in turns with
    the fold plan's (fold, fused, fused, fold). shared: inputs and oracle
    rows by (field, n, batch). Returns (its line, its kernels-line rows,
    the oracle's futures and what they are compared with), or None after
    the failure."""
    import numpy as np
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import colpass as C
    from ntt_aie_tpu_torch.ops import fused_fourstep as F
    from ntt_aie_tpu_torch.ops import gl_colpass as G
    from ntt_aie_tpu_torch.ops import modops as M
    from ntt_aie_tpu_torch.utils.timing import time_device

    (label, name, log_n, rows_log2, kw, nega, B, calls, perf_row,
     turns) = spec
    field = T.FIELDS[name]
    gl = field.is_goldilocks
    ops = _tall_ops(gl)
    cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2,
                      negacyclic=nega)
    n, (n1, n2) = cfg.n, cfg.split
    kind = "fused" if kw.get("fused") else "fold"
    t_case = time.perf_counter()
    # the inputs, and their rows' forward transforms on the oracle in
    # worker threads from here on (beside the set-up and the card's work)
    key_in = (name, log_n, B)
    if key_in not in shared:
        x = _tall_input(field, (B, n), dev, gen)
        rows_in = [(M.gl_to_u64(*(t[r] for t in x)) if gl
                    else x[r].cpu().numpy().astype(np.uint64))
                   for r in range(B)]
        shared[key_in] = {
            "x": x, "y": _tall_input(field, (B, n), dev, gen),
            "oracles": [pool.submit(_split_oracle, field, r)
                        for r in rows_in]}
        del rows_in
    x, y = (shared[key_in][k] for k in ("x", "y"))
    x, y = ((tuple(t.reshape(B, n1, n2) for t in v) if gl
             else v.reshape(B, n1, n2)) for v in (x, y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = T.build_plan(cfg, device=dev, **kw)
    bat = plan.make_batched(B)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    line = {"phase": "splits", "case": label, "field": name, "n": n,
            "split": [n1, n2], "batch": B, "plan": kw, "card": card,
            "reduction": plan.reduction, "setup_s": setup_s}
    chunks = max(1, (B * n) >> TALL_PLAIN_LOG)
    counters = ((F.fused_fourstep,) if kind == "fused"
                else (G.gl_colpass, G.gl_mul) if gl else (C.colpass,))

    def flat(v):
        return (tuple(t.reshape(B, n) for t in v) if gl
                else v.reshape(B, n))

    def mat(v, shape):
        return (tuple(t.reshape(shape) for t in v) if gl
                else v.reshape(shape))

    # the main path: each callable's launches counted from 0
    outs, by = {}, {}
    for key in calls:
        base = key[:-4] if key.endswith("_mat") else key
        if base in ("fwd", "inv"):
            src = x if base == "fwd" else outs.get("fwd_mat",
                                                   outs.get("fwd"))
            if base == "inv" and not key.endswith("_mat"):
                src = flat(src)
            elif base == "inv":
                src = mat(src, (B, n2, n1))
            args = (src if key.endswith("_mat") or base == "inv"
                    else flat(src),)
        else:
            args = ((x, y) if key.endswith("_mat") else (flat(x), flat(y)))
        torch.cuda.synchronize()
        _reset_counts()
        G.gl_mul.launches = 0
        outs[key] = bat[key](*args)
        torch.cuda.synchronize()
        by[key] = {k: v for c in counters for k, v in
                   (c.launches_by.items() if hasattr(c, "launches_by")
                    else [("gl_mul", c.launches)]) if v}
    passes = plan.passes
    chains = SPLIT_CHAINS[kind]
    want_by = {}
    for key in calls:
        want = want_by.setdefault(key, {})
        for c in _split_chains(key):
            for p in chains[c]:
                keys = ([F.fused_key(passes[p])] if kind == "fused"
                        else _split_keys(passes[p]))
                for k in keys:
                    want[k] = want.get(k, 0) + 1
        if gl and "polymul" in key:
            want["gl_mul"] = 1
    counts_ok = by == want_by

    def pointwise(a, b):
        if not gl:
            return plan.pointwise(a, b)
        return tuple(torch.cat(ps, dim=-1) for ps in zip(*(
            G.gl_mul_plain(tuple(t[..., c] for t in a),
                           tuple(t[..., c] for t in b))
            for c in torch.arange(a[0].shape[-1], device=dev).chunk(
                chunks))))

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    launch_fn = G.gl_colpass_launch if gl else C.colpass_launch
    launch_plain = G.gl_launch_plain if gl else C.launch_plain
    item = ops["itemsize"]
    errs, launch_ms, plain_ms, infos, rows = {}, {}, {}, {}, []
    step_ms, step_rows, limits_ok = {}, {}, {}

    def check_pass(k, v):
        """Every launch of pass k on its input v on the card against its
        plain version (column slices), timed; the launches against the
        pass's plain version. Returns that plain output."""
        cp = passes[k]
        ncols = v[0].shape[-1] if gl else v.shape[-1]
        whole = _by_columns(ops["plain"], v, cp, chunks, cp.transpose_out)
        infos[k] = ops["info"](cp, ncols)
        info_of = {i["variant"]: i for i in infos[k].get("phases",
                                                         [infos[k]])}
        u = v
        for launch in C.launch_plan(cp, ncols, itemsize=item):
            got = launch_fn(u, cp, launch)
            torch.cuda.synchronize()
            want, ms_p = timed(_by_columns, launch_plain, u, cp, chunks,
                               launch["transpose_out"], launch)
            tag = k + (launch["key"].rpartition("+tall")[2]
                       if launch["phase"] is not None else "")
            errs[tag] = _max_err(got, want)
            plain_ms[tag] = ms_p
            launch_ms[tag] = time_device(
                lambda _, u=u, launch=launch: launch_fn(u, cp, launch), u,
                iters=5, repeats=3)["us_per_iter"] / 1e3
            rows.append({"tag": tag, "launch": launch,
                         "info": info_of[launch["key"]]})
            del want
            u = got
        errs[f"{k}:pass"] = _max_err(u, whole)
        return whole

    def check_fused(k, v):
        """Fused transform k on v on the card against its plain version,
        timed; a step list's every step too: the list's steps up to it
        (fused_fourstep.step_prefix, run at the whole list's kernel, grid
        and shared memory) launched on the card against the steps' plain
        versions' chain (fused_step_plain), raw, and timed (a step's ms:
        its prefix's less the one before). Returns the plain output."""
        ff = passes[k]
        got = F.fused_fourstep(v, ff)
        torch.cuda.synchronize()
        want, ms_p = timed(F.fused_fourstep_plain, v, ff)
        errs[k] = _max_err(got, want)
        plain_ms[k] = ms_p
        launch_ms[k] = time_device(lambda _, v=v: F.fused_fourstep(v, ff),
                                   v, iters=5, repeats=3)["us_per_iter"] / 1e3
        infos[k] = F.kernel_info(ff, B)
        rows.append({"tag": k, "ff": ff})
        steps = F.fused_steps(ff)
        # no step's tile above one launch's rows; a step list's kernel at
        # more than one block an SM
        step_rows[k] = max(st["launch"]["rows"] for st in steps)
        limits_ok[k] = bool(step_rows[k] <= C.LAUNCH_ROWS and (
            F._whole(steps) or infos[k]["blocks_per_sm"] > 1))
        if F._whole(steps):
            return want
        del got
        u, prev_ms, step_ms[k] = v, 0.0, {}
        for j, st in enumerate(steps):
            u = F.fused_step_plain(u, ff, j)
            ms = launch_ms[k]
            if j < len(steps) - 1:
                prefix = F.step_prefix(ff, j)
                got = F._launch(v, ff, prefix, run=j + 1)
                torch.cuda.synchronize()
                errs[f"{k}:{st['name']}"] = _max_err(got.reshape(-1),
                                                     u.reshape(-1))
                del got
                ms = time_device(lambda _, v=v, prefix=prefix, j=j: F._launch(
                    v, ff, prefix, run=j + 1), v, iters=5,
                    repeats=3)["us_per_iter"] / 1e3
            step_ms[k][st["name"]] = ms - prev_ms
            prev_ms = ms
        errs[f"{k}:steps"] = _max_err(u.reshape(-1), want.reshape(-1))
        del u
        return want

    checked = set()

    def chain(c, v):
        """Chain c's plain version on v; each pass or fused transform the
        first time it runs is checked launch by launch on this input."""
        for k in chains[c]:
            if k in checked:
                v = (F.fused_fourstep_plain(v, passes[k]) if kind == "fused"
                     else _by_columns(ops["plain"], v, passes[k], chunks,
                                      passes[k].transpose_out))
            else:
                checked.add(k)
                v = (check_fused if kind == "fused" else check_pass)(k, v)
        return v

    results = {}
    fwd_out = mat(outs.get("fwd_mat", outs.get("fwd")), (B, n2, n1))
    plain_fwd = chain("fwd", x)
    if any(k.startswith("inv") for k in calls):
        chain("inv", fwd_out)
    for key in calls:
        if key.startswith("fwd"):
            results[key] = _max_err(mat(outs[key], (B, n2, n1)), plain_fwd)
        elif key.startswith("inv"):
            results[key] = _max_err(mat(outs[key], (B, n1, n2)), x)
        else:
            fc, _, ic = _split_chains(key)
            want = chain(ic, pointwise(chain(fc, x), chain(fc, y)))
            results[key] = _max_err(mat(outs[key], (B, n1, n2)),
                                    mat(want, (B, n1, n2)))
            del want
    del plain_fwd
    torch.cuda.empty_cache()

    # fwd on the native oracle: row 0 (and row 1 at B = 2), in a worker
    # thread where n is large
    oracles = shared[key_in]["oracles"]
    got_rows = [(M.gl_to_u64(*(t[r].reshape(n) for t in fwd_out)) if gl
                 else fwd_out[r].reshape(n).cpu().numpy().astype(np.uint64))
                [plan.spectral_to_natural] for r in range(B)]
    # fwd_mat as one call on CUDA events (each call on the same input);
    # the call's output is the one the oracle gates
    line["fwd_mat_us_per_call"] = time_device(
        lambda _: bat["fwd_mat"](x), x, iters=5, repeats=3)["us_per_iter"]
    if turns:  # fwd_mat in turns with the fold plan's at this split
        fold = T.build_plan(cfg, device=dev).make_batched(B)
        both = {"fold": fold, "fused": bat}
        line["fwd_mat_ms_in_turns"] = {"fold": [], "fused": []}
        for k in ("fold", "fused", "fused", "fold"):
            line["fwd_mat_ms_in_turns"][k].append(time_device(
                lambda _, k=k: both[k]["fwd_mat"](x), x, iters=3,
                repeats=3)["us_per_iter"] / 1e3)
        del fold, both

    ok_launches = not any(errs.values())
    ok_calls = not any(results.values())
    line.update({"launches_by": by, "launches_ok": counts_ok,
                 "launch_max_abs_err": errs, "callable_max_abs_err": results,
                 "roundtrip_ok": all(results[k] == 0 for k in results
                                     if k.startswith("inv")),
                 "launch_ms": launch_ms, "plain_launch_ms": plain_ms,
                 "step_ms": step_ms, "step_max_rows": step_rows,
                 "step_limits_ok": limits_ok,
                 "kernel_info": infos, "plain_chunks": chunks,
                 "method": "CUDA events (utils/timing.time_device), a "
                           "launch, a fused call or a step list's prefix "
                           "3 repeats of 5, trimmed mean, on the path's "
                           "own input; a plain launch one reading, its "
                           "check's own call, over plain_chunks column "
                           "slices",
                 "seconds": time.perf_counter() - t_case})
    ok = bool(counts_ok and ok_launches and ok_calls
              and all(limits_ok.values()))
    if not ok:
        emit(dict(line, ok=False))
        fail("splits", f"{label}: a launch, a step, a callable, the launch "
             "counts or a step list's limits failed")
        return None

    arithmetic = "goldilocks" if gl else plan.reduction
    krows = []
    for r in rows:
        tag = r["tag"]
        base = dict(perf_row=perf_row, route="cuda", max_abs_err=errs[tag],
                    ms=launch_ms[tag], plain_ms=plain_ms[tag], batch=B,
                    plain_batch=B, n=n, split=[n1, n2],
                    arithmetic=arithmetic)
        if "ff" in r:
            ff = r["ff"]
            key = F.fused_key(ff)
            tables = sum(t.numel() * t.element_size()
                         for t in (ff.wmid, ff.pre, ff.post)
                         if t is not None)
            krows.append(dict(
                base, name=f"fused_fourstep[split:{label}:{tag}]",
                source="ntt_aie_tpu_torch/csrc/fused_fourstep.cu",
                replaces="ntt_aie_tpu/ops/pallas_ntt.py:693", variant=key,
                launches=sum(v.get(key, 0) for v in by.values()),
                bytes=2 * B * n * 4 + tables,
                butterflies=B * n // 2 * log_n, steps=infos[tag]["steps"],
                kernel=infos[tag]["kernel"],
                tile_cols=infos[tag]["tile_cols"],
                registers=infos[tag]["registers"],
                blocks_per_sm=infos[tag]["blocks_per_sm"],
                grid=infos[tag]["grid"]))
            continue
        launch, info = r["launch"], r["info"]
        key = launch["key"]
        krows.append(dict(
            base, name=f"{ops['name']}[split:{label}:{tag}]",
            source=ops["source"], replaces=ops["replaces"], variant=key,
            launches=sum(v.get(key, 0) for v in by.values()),
            bytes=2 * B * n * item + _launch_bytes(launch, item),
            butterflies=B * n // 2 * len(launch["ts"]),
            rows=launch["rows"], view_cols=launch["ncols"],
            batch_mult=launch["batch_mult"], group=launch["group"],
            tile_cols=launch["tile_cols"], short=launch["short"],
            registers=info["registers"],
            blocks_per_sm=info["blocks_per_sm"],
            **({"perf_row": "3q"} if launch["short"] else {})))
    return line, krows, (oracles, got_rows)


def split_phase(dev, card, gen):
    """Phase 41: SPLIT_CASES (_split_case); the oracles' rows gathered at
    the end (their threads run beside the card's work). Returns the
    kernels-line rows, or None after the failure."""
    import concurrent.futures

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    rows, pending, shared = [], [], {}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for spec in SPLIT_CASES:
            got = _split_case(spec, dev, card, gen, pool, shared)
            if got is None:
                return None
            line, krows, oracle = got
            pending.append((line, oracle))
            rows += krows
            torch.cuda.empty_cache()
        shared.clear()
        gates = []
        for line, (futures, got_rows) in pending:
            oks = []
            for fut, got in zip(futures, got_rows):
                want, oracle = fut.result()
                oks.append(bool(np.array_equal(got, want)))
            gates.append(all(oks))
            emit(dict(line, oracle=oracle, gate_ok=all(oks), ok=all(oks)))
    if not all(gates):
        fail("splits", "a forward transform disagrees with the native "
             "oracle")
        return None
    emit({"phase": "splits_done", "ok": True, "rows": len(rows),
          "seconds": time.perf_counter() - t_phase})
    return rows


def pointwise_phase(dev, card, gen):
    """Phase 42: the 32-bit pointwise product against its plain version
    for each of PW_MODULI (raw, every form the kernel takes), then timed
    at PW_TIMED beside the plain version and its byte bound. Returns its
    kernels-line row (launches filled in by main), or None after emitting
    the failure."""
    import torch

    import ntt_aie_tpu_torch as T
    from ntt_aie_tpu_torch.ops import pointwise as PW
    from ntt_aie_tpu_torch.utils.timing import time_device

    def values(shape, p):
        """Random uint32 bits as int32, the first values the edges."""
        v = torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int64,
                          device=dev, generator=gen)
        edges = [e for e in (0, 1, p - 1, p, 2 * p, 4 * p - 1,
                             (1 << 31) - 1, 1 << 31, (1 << 32) - 1)
                 if e < 1 << 32]
        flat = v.view(-1)
        flat[:len(edges)] = torch.tensor(
            [e - (1 << 32) if e >= 1 << 31 else e for e in edges],
            dtype=torch.int64, device=dev)
        return v.to(torch.int32)

    max_err = 0
    forms = (((1 << 20) + 3,), None), ((4, 1 << 20), None), \
        ((4, 1 << 20), (1 << 20,)), ((6, 3 * 1024), (3 * 1024,)), \
        ((4097,), "unaligned")
    for modulus in PW_MODULI:
        p = modulus if isinstance(modulus, int) else T.FIELDS[modulus].p
        errs = {}
        for shape_a, form in forms:
            a = values(shape_a, p)
            if form == "unaligned":
                b = values(shape_a, p)
                a, b = a[1:], b[1:]
            else:
                b = values(form or shape_a, p)
            got = PW.mul32(a, b, p)
            torch.cuda.synchronize()
            want = PW.mul32_plain(a, b, p)
            err = int((got.long() - want.long()).abs().max())
            key = "x".join(map(str, shape_a)) + (
                f"*{form}" if isinstance(form, str) else
                f"*{'x'.join(map(str, form))}" if form else "")
            errs[key] = {"max_abs_err": err,
                         "vectorized": PW.vectorized(a, b, got)}
            max_err = max(max_err, err)
            if err or not torch.equal(got, want):
                emit({"phase": "pointwise", "p": p, "errors": errs})
                fail("pointwise", f"mul32 over p = {p} at {key} differs "
                     "from its plain version")
                return None
        emit({"phase": "pointwise", "p": p, "forms": errs,
              "max_abs_err": 0})

    times = {}
    for name, n, B in PW_TIMED:
        p = T.FIELDS[name].p
        a, b = (torch.randint(0, p, (B, n), dtype=torch.int32, device=dev,
                              generator=gen) for _ in range(2))
        k_us = time_device(lambda v: PW.mul32(v, b, p), a)["us_per_iter"]
        k_bc = time_device(lambda v: PW.mul32(v, b[0], p),
                           a)["us_per_iter"]
        p_us, pb = _plain_batch_time(
            lambda v: (PW.mul32_plain(v[0], v[1], p), v[1]), (a, b), B)
        nbytes = 12 * B * n
        bound_us = nbytes / (SPEC_HBM_GBPS * 1e3)
        times[name] = {
            "p": p, "n": n, "batch": B, "kernel_us_per_call": k_us,
            "kernel_us_per_ntt": k_us / B,
            "kernel_broadcast_us_per_call": k_bc,
            "plain_us_per_call": p_us * B / pb, "plain_batch": pb,
            "plain_us_per_ntt": p_us / pb, "bytes": nbytes,
            "byte_bound_us_per_ntt": bound_us / B,
            "time_over_bound": k_us / bound_us}
        del a, b
        torch.cuda.empty_cache()
    emit({"phase": "pointwise", "card": card, "times": times,
          "method": "CUDA events; kernel: 5 repeats of a dependent chain of "
                    "10 (a * b with b of a's shape; broadcast: b one row), "
                    "plain: 3 repeats of 2 (b of a's shape); trimmed mean; "
                    "the bound 12 bytes a value (a and b read, o written) at "
                    f"{SPEC_HBM_GBPS} GB/s"})
    main = times["p469762049"]
    return {"name": "pointwise32", "route": "cuda",
            "source": "ntt_aie_tpu_torch/csrc/pointwise.cu",
            "replaces": "ntt_aie_tpu/plan.py:175 (XLA pointwise product, "
                        "not a TPU kernel)",
            "launches": 0, "max_abs_err": max_err,
            "ms": main["kernel_us_per_call"] / 1e3,
            "plain_ms": main["plain_us_per_call"] / 1e3,
            "batch": main["batch"], "plain_batch": main["plain_batch"],
            "bytes": main["bytes"], "butterflies": 0, "arithmetic": None,
            "times": times}


if __name__ == "__main__":
    sys.exit(main())
