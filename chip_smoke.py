#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's v1 to v4 provers (v1 over all six fields), its zerocheck,
Poseidon2, 64-bit fold and Reed-Solomon encode kernels,
its forest's memory plan at 2^25 steps, its base-field device zerocheck,
its standalone modules and its sharded prover (two ranks sharing the card)
on one NVIDIA GPU and check them.

    python3 chip_smoke.py        (from the root of a checkout; needs one CUDA device)

The script imports ``zigz_tpu_torch`` and nothing of JAX or of the JAX
package ``zigz_tpu``: both are blocked from import before the port loads.
The reference for every proof is data: the golden fixtures under
tests/fixtures/ and the pinned byte lengths and sha256 digests of
zigz_tpu_torch/testdata/proof_digests.json (made on a CPU by
scripts/torch_reference_digests.py from zigz_tpu's host path), plus the
port's own ``Verifier``.  A digest that differs raises.

Phases, in order; any failure raises, so the script exits non-zero before
the last line:

  0. the card: nvidia-smi name, power limit and clocks, torch and CUDA
     versions.  Without a CUDA device the script exits 2 and prints no
     result.
  1. build the CUDA kernels from zigz_tpu_torch/csrc/ (one nvcc per unit,
     all started together, sm_90a) and the host C++ runtime from
     zigz_tpu_torch/runtime/ (one g++ per library, all started together);
     count the Keccak permutation's integer instructions in the built
     library's SASS (``cuobjdump -sass``), for the kernels' bounds.  Then
     Z1's generated kernels: the programs of the v2 prove (v3's and v4's are
     the same), captured from a 16-step prove on the CPU
     (``capture_zerocheck_specs``), one nvcc each into
     build/zigz_tpu_torch/dag/, all started together; they build while
     phases 2 to 5 run, and before phase 6 each program's nvcc seconds,
     registers and spill bytes (``-Xptxas -v``) are printed.
  2. each kernel against its plain PyTorch version on the card, digests
     equal to the byte (tolerance 0), kernel and plain times by CUDA events:
     K1 on 43 * 2^20 random canonical values (the leaf level of a
     2^20-step forest) and K2 on the 43 * 2^19 pairs of that level, with
     ragged sizes 1, 255 and 4097 and the edge values 0, p - 1 and
     2^64 - 1; K5 on one full 544-row stream block at n_e = 2^19 (the
     2^20 v2 DATA commit's width) from a random carried state; K4 on
     the two column shards that a rank of two sponges in the sharded 2^20 v2
     prove of phase 15, 2,540 x 2^18 (ADVICE, the entry of the kernel line)
     and 2,089 x 2^18 (DATA), and on 688 x 2^19 (``ligero_commit_device`` of
     the 43 witness MLEs at 2^20), each with its own times and bound; K4
     and K5 (driven over the raw rows) at 1, 255 and 4097 columns times
     1, 33, 34, 543, 544 and 545 rows with the values 0 and p - 1.
     A hashlib check of a sample for every kernel.  Each kernel's bound:
     the larger of its bytes (inputs read once, outputs written once) over
     3.35 TB/s and its operations at the card's maximum SM clock, under the
     issue slots (128 a clock an SM) against the ALU and FMA pipes (64
     each): for K1 and K2 the hashes times the SM clocks one thread takes
     for one, from its whole SASS counted at every address
     (``issue_count``); for K4 and K5, which loop, the rate blocks times one
     block's count and the columns times a column's own code, from chains
     of 2 and 1 blocks (``bound_chain_counts``); the superseded count, K2's
     first 4,096 instructions over 132 SMs x 64 INT32 lanes, is logged
     beside it, and for K4 and K5 their whole SASS billed to every block.  No
     PyTorch call computes SHA3-256, so ``library_ms`` is null.
     Then the Poseidon2 kernels (csrc/poseidon2_kernels.cu over the
     permutation P0 of csrc/poseidon2.cuh; they replace the JAX package's
     jitted jnp, not a Pallas kernel) against their plain versions on the
     same card tensors, byte error 0, and against core/poseidon2.py
     (``np_batch_leaf_hashes``, ``np_batch_merge_hashes`` and its sponge
     steps over ``np_permute``) on every hash of the ragged sizes and a
     sample of the large ones: P1 ``p2_leaves`` on 43 * 2^20 values (the
     leaf level of the 2^20-step v3 forest), P2 ``p2_merge`` on 43 * 2^19
     pairs, P3 ``p2_absorb`` of one 544-row block at n_e = 2^19 into a
     random carried state and at one resident wave of P3's columns (its
     blocks an SM, from the occupancy query ``zigz_p2_absorb_blocks_per_sm``, x
     SMs x 128), P1/P2 at 1, 2, 31, 33, 127, 129, 255 and 4097 hashes and
     parents and P2 on a level of 3 trees, P3 at 1, 31, 33, 255 and 4097
     columns times 0, 1, 7, 8, 9, 543, 544 and 545 rows; the column sponge
     against ``_hash_columns(..., "poseidon2")``.  Kernel and plain times
     by CUDA events at the main shapes (P3 also at the one-wave shape, with
     both shapes' time a column), the launches of one call
     (``torch.profiler``), and the bound: the permutations times the SM
     clocks of one, against the bytes.  Phase 1 builds P1 once more with
     P0's round loops unrolled (``poseidon2_unrolled_count``, beside the
     kernels' build) and counts one whole permutation's instructions in its
     SASS: the clocks are the largest of its issue slots (128 a clock an SM)
     and its ALU-pipe and IMAD instructions (64 a clock an SM each); the
     first CUDA version's yardstick (3,987 instructions over the INT32
     lanes) is logged beside each bound for comparison.  No PyTorch call
     computes Poseidon2 (``library_ms`` null).  P1-P3's registers and spills
     (ptxas) are printed in phase 1.  Then the device function that is torch
     ops, not a kernel (the JAX package computes it in jnp):
     ``vecmat_device`` against the host ``_vecmat``, its time by CUDA events
     and its launches (``torch.profiler``) at the width of the 2^20 proves.  The three advice twins are held against the host
     advice columns of every v2, v3 and v4 prove below, plane by plane,
     after that prove has returned (its timings carry none of the check).
  2c. E1, the 64-bit fold (csrc/field64_kernels.cu over csrc/field64.cuh;
     no TPU kernel: zigz_tpu evaluates these fields with object-dtype
     integers on the host), against ``_fold_lsb_u64_plain`` on the same
     card tensors over Goldilocks and Mersenne61 (``field64_kernel_phase``):
     every fold of the 43 x 2^22 and 43 x 2^10 evaluations, one row of
     2^10, v = 0, single folds at (1, 2), (3, 6) and (5, 510), edge values
     (0, 1, p - 1, and for Goldilocks 2^63 and more) among values and
     challenges; byte error 0; the whole 2^22 evaluation and its first fold
     by CUDA events, kernel and plain; the bound from the bytes against the
     outputs x one thread's SM clocks (``issue_count`` of the field's
     instantiation); ptxas's registers and spills.  No PyTorch call
     computes a 64-bit modular fold (``library_ms`` null).
  2d. N1 and N2, the Reed-Solomon row encode of every Ligero commit
     (csrc/ntt_kernels.cu over csrc/ntt.cuh; they replace the JAX
     package's jitted jnp four-step NTT, not a Pallas kernel), against
     ``_encode_rows_plain`` on the same card tensors
     (``ntt_kernel_phase``), byte error 0: (544, 2^16) -> 2^19 (a stream
     block of the v2-v4 2^20 commits), (544, 2^17) -> 2^20 (the same at
     2^22 steps) and (688, 2^16) -> 2^19 (``ligero_commit_device`` at
     2^20); (3, 2^20) -> 2^22 and (1, 2^14) -> 2^27, whose global stages
     take N2 two passes, and (1, 2^8) -> 2^27; and 0, 1, 33 and 545 rows x
     n_out 2, 2^12, 2^13 and 2^14 (the tile of 2^13 outputs, its half and
     its double) x n 1, n_out / 8 and n_out with 0 and p - 1 among the
     values; each call's launches N1 once and N2 once a pass of
     ``n2_passes``, the header's plan (none for no rows).  At the timed
     shapes the encode, N1 alone and each N2 pass by CUDA events, the plain
     version's ms, and the bounds: the butterflies x one butterfly's SM
     clocks (``bound_chain_counts``: phase 1 builds
     csrc/measure/bound_chains.cu, which is not a unit of the kernels'
     library, beside the kernels' build, and counts the difference of
     chains of 64 and 32 butterflies in the SASS), against the bytes (an N2
     pass: all of its stages' butterflies against one read and one write of
     the block); ptxas's registers and spills.  No PyTorch call computes a
     BabyBear NTT (``library_ms`` null).
  2e. W1, the witness rows (csrc/witness_kernels.cu over
     csrc/witness.cuh; no TPU kernel: zigz_tpu builds them in jitted jnp
     after packing the columns on the host), against
     ``_witness_rows_plain`` on the same card tensors over BabyBear,
     Goldilocks and Mersenne61 (``witness_kernel_phase``): 777 steps in
     2^10 rows and 4,190,000 in 2^22, edge values among them, byte error 0,
     one launch a call; one ``build_witness`` a launch; W1, its plain
     version and the register fill by CUDA events at 2^22; the bound by
     bytes; ptxas's registers and spills.
  2b. the bench's multiply-chain kernel (csrc/field_kernels.cu, the
     headline of bench_torch.py; no TPU counterpart): ``babybear.mul_chain``
     against ``_mul_chain_plain`` on the card at 2^22 elements and at the
     ragged sizes 1, 255 and 4097, with 0, 1 and p - 1 among x and y, byte
     error 0; kernel and plain times by CUDA events around 20 reps queued
     behind a spin (``bench_torch.queued_event_ms``: a rep is shorter than
     its launch from Python); its bound from its whole SASS (each thread
     takes one element, so every instruction runs once an element) under
     the issue-slot and two-pipe model, against 12 B an element over
     3.35 TB/s; the superseded count (its integer instructions over 132
     SMs x 64 INT32 lanes) logged beside it.  No PyTorch
     call fuses the chain (``library_ms`` null).  Then this slice's path:
     ``bench_torch.main`` at v1 2^14 and 2^18 only (headline at 2^22 lanes,
     the host anchor, the two ladder sizes pinned for the bench), its last
     line parsed, the kernel's launches counted over that run.
  3. the port's v1 proof bytes equal tests/fixtures/{nop4,add,fibonacci}_v1.bin.
  4. at 2^16 and 2^20 NOP steps and for the fibonacci guest (900,013
     steps), the port's v1 proof equals its pinned digest and verifies
     Accept.
 4b. v1 over the other fields below 2^31: 2^16 NOP steps over KoalaBear and
     over Mersenne31, each equal to its pinned digest (made by zigz_tpu's
     host path) and verified Accept by the port.
  5. the v1 main path: Prover(BabyBear, device="cuda").prove at 2^22 NOP
     steps, once, equal to its pinned digest and verified Accept; phase
     timings, steps/s, the forest's plan (nothing freed, one group) and
     peak device memory, allocated and reserved.
 4c. (after phase 5, ``wide_field_phases``) v1 over Goldilocks and
     Mersenne61: 2^16 and 2^20 NOP steps and the wide-value guest of
     tests/torch_wide_guest.py (its code in the pin) in each field, equal
     to the pins made by zigz_tpu's host path and verified Accept; E1
     launched once a variable, K1 once, K2 once a level.
 5b. this slice's full-width run: both fields at 2^22 NOP steps, two
     passes in one process with equal bytes, Accept, total_s, the phase
     split and the peak device memory allocated and reserved.
  6. the v2 main path: Prover(BabyBear, device="cuda", protocol_version=2)
     at 2^16 NOP steps, for the fibonacci guest (60,013 steps) and at 2^20
     NOP steps, each equal to its pinned digest and verified Accept.  The
     commitments, every zerocheck and the Lasso rounds run on the card:
     both commit paths must be "stream-dev", the count of zerochecks
     proven by GenericDeviceZerocheckExt must equal the count of zerocheck
     proofs in the proof, and the Lasso device rounds must be > 0.  One
     line per case prints zerochecks_s, dag_build_s (its wait on nvcc for
     Z1's generated kernels, 0 once phase 1 built them), zerocheck_host_s
     (its host tracing and constant folding), zerocheck_start_s (the
     zerochecks made after each advice phase, where their builds start),
     lasso_s, total_s, those counts,
     the columns read from the resident matrices against those uploaded,
     the DAG sweep's launches and peak device memory, the advice planes
     built on the device (148 at 2^20), the build time of each twin and
     the ADVICE rows that were uploaded.  The sweep is the zerocheck
     kernels Z1 and Z2 alone: their launches must be those each
     zerocheck's width and host tail imply (two a card round), at most
     1,000 at 2^20.  Every encode runs on the card: N1 once a 544-row
     stream block of each commit and once more a block in the openings,
     N2 once a stage of each (phases 8 and 9 alike).
  7. ``ligero_commit_device`` of 43 random MLEs at 2^18: root, leaf digests
     and levels equal the port's host ``ligero_commit`` (the C++ encoder and
     column hasher) of the same columns, N1 launched once and N2 once a
     stage; the state, whose matrix lies on
     the device, is opened with ``ligero_prove_eval`` (``vecmat_device``,
     ``column_evals_device``) and verified with ``ligero_verify_eval``.
  8. protocol v4 (the 43 witness MLEs under the DATA commitment, no
     forest) at 2^16 and 2^20 NOP steps: pinned digest, Accept, K1 and K2
     launches 0, K5 launches > 0, the DATA commit's total_rows, n and n_e.
  9. protocol v3 (Poseidon2 forest and column sponge, kernels P1-P3) at
     2^16 NOP steps, for the fibonacci guest (60,013 steps) and at 2^20 NOP
     steps: pinned digest, Accept, no SHA3 kernel launched, no plain
     Poseidon2 permutation; P1 once and P2 once a level of the forest, P3
     once a 544-row stream block of each commit (9 at 2^20).
 9b. the zerocheck kernels (Z1 generated for each program around
     csrc/dag_round.cuh, Z2 in csrc/zerocheck_kernels.cu; they replace the
     JAX package's XLA-fused jit, not a Pallas kernel) against their plain
     versions on the same card tensors, values equal (tolerance 0), on the
     DAGs of phase 6's 2^20 v2 prove traced with random challenges
     (``zerocheck_kernel_phase``): Z1 ``dag_dev.round_sums`` with the
     largest DAG's round-0 program at width 2^20 and its later-round
     program at 2^19, the smallest DAG at 2^20, 64 and 2, and phase 12's
     base-field grand product with its eq row at 2^20; Z2
     ``ext4_dev.fold_planes`` from the round-0 layout at 2^20 and from the
     all-extension layout at 2^19; then Z1 on every distinct program of
     the prove once, at the widest width the prove gives it, each with its
     build's nvcc seconds, registers and spills.  Times by CUDA events; Z1's bound from
     the DAG's multiplies and adds (the multiply chain's integer
     instructions a multiply, from its SASS, and 3 an add) over the INT32
     rate, against the planes' bytes; Z2's from its bytes.  No PyTorch
     call evaluates a DAG or an Ext4 fold (``library_ms`` null).
 10. the forest's memory plan at sizes that have a reference: with the
     thresholds of commitments/device_forest.py forced low (three levels
     freed, three groups of 16, 16 and 11 trees), v1 at 2^22 NOP steps and
     for the fibonacci guest (900,013 steps) and v3 at 2^16 NOP steps
     (Poseidon2 forest) equal their pinned digests and verify Accept; K1
     runs once per group and once per freed level of the openings, K2 once
     per level per group and k times for the freed level k (P1 and P2
     alike for v3).
 11. the size the forest cannot hold whole: Prover(BabyBear).prove at 2^25
     NOP steps with the thresholds as shipped (the plan frees levels 0..2
     and builds in groups of 16 trees on its own; all levels would be
     92.4 GB).  No reference digest exists at this size, so the proof is
     held three ways: the port's Verifier accepts it (all 43 openings
     against the roots); every tree's root equals the root of that tree
     built alone by K1/K2 with nothing freed; every opened sibling, at the
     freed levels and above, equals the same node of that single-tree
     build.  Prints forest_s, opens_s, total_s, steps/s, the plan, K1/K2
     launches, and the peak device memory allocated and reserved.  Then
     2^24 NOP steps once with the thresholds as shipped and once with
     nothing freed and one group (the forest as it was before the plan),
     for the peak each needs.
 12. the base-field device zerocheck (ops/zerocheck_gen.py) of a
     grand-product combiner (five columns, degree 4) at width 2^20 through
     ``make_zerocheck_prover(..., device=card)``, against the native C++
     prover from the same transcript: round values, challenges, terminal
     evaluations and the transcript's next challenge equal; its card rounds
     (those wider than the numpy tail) one launch of Z1 each; time printed.
 13. the standalone modules, host code that must import and run here with
     JAX blocked: ``SumcheckProver.prove`` on a 2^16 polynomial, accepted by
     ``SumcheckVerifier.verify_rounds`` against the hypercube sum; a
     ``LassoProver`` proof of 64 queries into the 4-bit XOR table, whose
     rounds verify against the queries' sum and which
     ``LassoVerifier.verify_fast`` accepts; ``HostMerkleForest`` (one
     native call) roots and openings equal ``DeviceMerkleForest`` on the
     card at 43 x 2^12.
 14. the sharded prover's pieces on two ranks that share the card.  A rank
     is this script started again with ``--rank`` (JAX and zigz_tpu blocked
     there too), joined by ``torch.distributed`` with gloo as the transport
     (NCCL refuses two ranks on one GPU), both on ``cuda:0``, every
     collective staged through the host (zigz_tpu_torch/parallel/).  Each
     The rank functions are those of tests/torch_group_checks.py.  Each
     piece must equal its single-device result on both ranks:
     ``DistSumcheckProver`` on 2^20 seeded values against the host
     ``SumcheckProver``'s proof bytes; ``device_prove_step`` at (43, 2^20);
     ``commit_columns_mesh`` at the 2^20 v2 DATA commit's shape (2,089 x
     2^16, n_e = 2^19) against ``sha3_columns_stream``'s digest blob, K4
     launched once on each rank, and ``MeshEncoded.gather`` of 64 columns
     against ``StreamedEncoded.gather``; ``prove_rounds_mesh`` over tables of
     20, 20, 18, 16 and 10 variables against the native rounds (rounds,
     challenges, terminal evaluations, the transcript's next challenge); the
     forest at (43, 2^16) under a forced plan.  Then one rank under
     ``"nccl"``: every collective wrapper once on CUDA tensors.
 15. this slice's path at full width: ``Prover(BabyBear, device="cuda:0",
     group=...)`` on the two ranks at 2^22 NOP steps (v1) and 2^20 NOP steps
     (v2), each rank's proof equal to the pinned digest and verified Accept;
     v2's ``data_commit_sharded``, ``advice_commit_sharded``,
     ``batch_eval_sharded`` and ``open_sharded`` true and
     ``zerochecks_sharded`` false, and the two commits' shapes those whose
     column shards phase 2 held K4 to; per rank the K1/K2/K4/K5 and N1/N2 launches (K1, K2
     and, for v2, K4, N1 and N2 > 0), the forest's plan, the phase timings and the peak
     device memory.  Then a job whose rank 1 kills itself after
     ``initialize``: the launcher must fail inside its timeout and leave no
     result file, and the relaunch must give the pinned digest.  Two ranks
     time-share one card: their figures are printed as what they are and
     compared with nothing.

The kernel launch counters are reset before each prove or commit and must
be > 0 after it; the kernel line takes K1/K2's from phase 5 (their
launches on the wide-field proves of phases 4c and 5b beside them), E1's
from the Goldilocks 2^22 prove of phase 5b (every wide prove beside it),
its measurements from phase 2c
(``launches_large`` beside them from the 2^25 prove of phase 11), K5's from the
2^20 prove of phase 6 (``launches_v4`` beside it from phase 8) and K4's from
rank 0 of the sharded 2^20 v2 prove of phase 15, the one prove that runs it
(``launches_commit_device`` beside it from phase 7, ``other_shapes`` its
measurements at the other two shapes of phase 2); K3, the permutation inlined in all four, is listed with K2's
measurements (one permutation per thread) and K1's plus K2's launches; every
entry carries the launches per rank of phase 15's two proves
(``launches_group_v1_2_22``, ``launches_group_v2_2_20``).  The multiply-chain kernel's entry takes its
launches from the bench run of phase 2b.  Z1's and Z2's entries take their
launches from the 2^20 v2 prove of phase 6 (v3, v4 at 2^20 and v2 at 2^16
beside them) and their measurements from phase 9b.  P1-P3 take their
launches from the 2^20 v3 prove of phase 9 (v3 2^16, the fibonacci guest and
phase 10's forced plan beside them) and their measurements from phase 2; P0,
the permutation inlined in all three, is listed with P1's measurements and
the three's launches.  N1 and N2 take their launches from the 2^20 v2
prove of phase 6 (v3, v4 at 2^20, v2 at 2^16, phase 7 and the ranks of
phase 15's v2 prove beside them) and their measurements from phase 2d: N1
alone and the mean of the N2 stages at (544, 2^16) -> 2^19, the whole
encode at the three main shapes on N1's entry, the plain version being the
whole encode's.  The last three lines are the
kernel JSON line, the card's nvidia-smi line and the result line
{"ok": true, "device": {...}}.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.modules["jax"] = None  # any import of jax or of the JAX package now raises ImportError
sys.modules["zigz_tpu"] = None

P = 2013265921
NOP = bytes([0x13, 0x00, 0x00, 0x00])
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES = 132 * 64  # SMs x INT32 lanes per SM and clock (Hopper white paper)
INT_OPCODES = ("LOP3", "SHF", "IADD3", "IADD", "VIADD", "IMAD", "LEA", "PRMT", "MOV", "ISETP", "SEL", "IMNMX")
SASS_OPCODE = r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)"
# The same at every address: SASS_OPCODE reads four hex digits of address, so
# it stops at the first 4,096 instructions of a function (K2's count is the
# first 4,096's; PERF.md §6).
ALL_SASS_OPCODE = r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)"
# The Poseidon2 kernels' operations: the instructions of one whole
# permutation, counted in the SASS of P1 built with P0's round loops unrolled
# (poseidon2_unrolled_count), each of which runs once a permutation.  Every
# instruction takes an issue slot (an SM's 4 warp schedulers issue one warp
# instruction a clock each, 128 thread instructions), and the integer ALU
# pipe's and the FMA pipe's integer instructions retire at 64 a clock an SM
# each (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0); the bound is the largest of the three times.
# An opcode whose pipe is not known for certain (VIADD, MOV) counts in the
# issue slots only.
SM_COUNT = 132
# The kernels of the Reed-Solomon encode as ptxas names them: the templates'
# instances the main path launches, at fixed shapes (N1 a tile of 2^13 with
# k = 8, 32 values a thread; N2 the pass of stages 13..18, 16 values).
NTT_KERNELS = {"N1": "ntt_tile_kernelILi5EN8zigz_ntt5FixedILi13ELi3ELi3E",
               "N2": "ntt_pass_kernelILi4EN8zigz_ntt5FixedILi11ELi5ELi13E"}
# N2's launches the slice's proves must make: 1 a block (one pass at n_e =
# 2^19), each block encoded at commit time and again in the openings.
N2_LAUNCHES = {"v2-nop-2^20": 18, "v3-nop-2^20": 18, "v4-nop-2^20": 22, "v2-nop-2^16": 8, "v3-nop-2^16": 8,
               "ligero_commit_device": 1, "rank of the sharded v2-nop-2^20": 10}
ISSUE_LANES = 128  # thread instructions issued a clock an SM
P2_PIPES = {"ALU": (("IADD3", "LOP3", "ISETP", "SEL", "SHF", "LEA", "PRMT", "IMNMX", "PLOP3"), 64),
            "FMA": (("IMAD",), 64)}
# The first CUDA version's count, printed beside the bounds for comparison
# only: 3,987 integer instructions, the first 4,096 instructions of its P1
# (SASS_OPCODE's cap), over INT32_LANES (PERF.md §6).
P2_FIRST_VERSION_INSTR = 3987
V2_DATA_ROWS = 2089  # rows of the 2^20 v2 DATA commit, n = 2^16, n_e = 2^19
V2_ADVICE_ROWS = 2540  # rows of its ADVICE commit, same n and n_e
GROUP_KEYS = {"leaves": "K1", "merge": "K2", "columns": "K4", "absorb": "K5"}  # a rank's launch counts


def log(msg: str) -> None:
    print(msg, flush=True)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def make_grand_product(tau: int, gamma: int):
    """The base-field combiner of phase 12: fingerprint products,
    public-column mixing, degree-3 gating, over the columns a, b, g,
    __sel__ and __idx__."""
    def grand_product(cols, alphas, p):
        sel, idx = cols["__sel__"], cols["__idx__"]
        a, b, g = cols["a"], cols["b"], cols["g"]
        fp = (tau + p - (a + gamma * b) % p) % p
        c1 = (g * fp + p - sel) % p
        c2 = sel * ((1 + p - sel) % p) % p
        c3 = sel * b % p * ((idx + a) % p) % p
        return (alphas[0] * c1 + alphas[1] * c2 + alphas[2] * c3) % p

    return grand_product


def zerocheck_spec(zc) -> dict:
    """What the zerocheck kernels' phase needs of a GenericDeviceZerocheckExt:
    its combiner, tables, degree, row maps and programs (no column data)."""
    return dict(combiner=zc.combiner, base_names=list(zc.base_names), ext_names=list(zc.ext_names),
                degree=zc.degree, num_alphas=zc.num_alphas, row_maps=zc._row_maps(),
                nodes=len(zc._probe2.nodes), n=zc.n, host_tail=zc.host_tail, programs=zc.programs)


class _ZerochecksDone(Exception):
    pass


def capture_zerocheck_specs(version: int = 2) -> list:
    """``zerocheck_spec`` of every extension zerocheck of a 16-step NOP
    prove of ``version`` on the CPU, stopped after its zerochecks: the DAGs'
    structure is the same at every width, so their programs are those of a
    prove on the card, and nothing is built for the card here."""
    import zigz_tpu_torch as zt
    from zigz_tpu_torch.ops import zerocheck_dev_ext
    from zigz_tpu_torch.prover import unified

    specs = []
    cls = zerocheck_dev_ext.GenericDeviceZerocheckExt
    prove, batch_eval = cls.prove, unified.prove_batch_eval

    def watched(self, transcript):
        specs.append(zerocheck_spec(self))
        return prove(self, transcript)

    def stop(*_args, **_kwargs):
        raise _ZerochecksDone

    cls.prove, unified.prove_batch_eval = watched, stop
    try:
        zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=version).prove(
            NOP * 16, 0x1000, None, 1 << 12, None, None)
    except _ZerochecksDone:
        pass
    finally:
        cls.prove, unified.prove_batch_eval = prove, batch_eval
    return specs


def card_zerocheck_launches(n: int, host_tail: int) -> int:
    """Z1 and Z2 launches of one extension zerocheck of width n: Z1 for
    round 0, Z2 and Z1 for every later round whose width before the fold
    stays above the host tail, and the last fold where no round went to the
    host (ops/zerocheck_dev_ext.py)."""
    num_vars = n.bit_length() - 1
    on_card = [rnd for rnd in range(1, num_vars) if n >> rnd > host_tail]
    return 1 + 2 * len(on_card) + (len(on_card) == num_vars - 1)


def zerocheck_kernel_phase(specs, dev, max_sm_mhz: float, mul_instr: float, add_instr: int) -> dict:
    """Phase 9b: the zerocheck kernels Z1 (``dag_dev.round_sums``) and Z2
    (``ext4_dev.fold_planes``) against their plain versions on the same card
    tensors, values equal (tolerance 0), ms by CUDA events, bounds.

    ``specs`` are the extension zerochecks of a v2 prove (``zerocheck_spec``).
    Z1: the largest DAG's round-0 program at width 2^20 and its later-round
    program at 2^19 (the shapes of the 2^20 prove), the smallest DAG at
    2^20, 64 and 2, and the base-field grand product of phase 12 with its eq
    row at 2^20, each traced with random extension (or base) challenges;
    then every distinct program of the prove once, at the widest width the
    prove gives it (``z1_programs``).  Each Z1 entry carries its generated
    kernel's build (``build_report``).  Z2: a fold of the largest
    zerocheck's tables from the round-0 layout at 2^20 and from the
    all-extension layout at 2^19.  Z1's bound is the
    larger of its field operations (multiplies x ``mul_instr`` and adds and
    subtracts x ``add_instr`` integer instructions a lane-point, over 132 SMs
    x 64 INT32 lanes x the maximum clock) and the planes' bytes read once;
    Z2's the bytes read once and written once, both over 3.35 TB/s."""
    import numpy as np
    import torch

    from zigz_tpu_torch.core.ext4 import ext_from_ints
    from zigz_tpu_torch.ops import dag_dev, ext4_dev
    from zigz_tpu_torch.ops.symtrace import compile_device, trace_combiner, trace_combiner_ext
    from zigz_tpu_torch.ops.zerocheck_dev_ext import fold_groups

    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(9)

    def planes_of(rows, width):
        """(rows, width) random canonical int64, 0 and p - 1 among lo and hi."""
        pl = torch.randint(0, P, (rows, width), device=dev, dtype=torch.int64, generator=gen)
        edge = torch.tensor([0, P - 1], device=dev, dtype=torch.int64)
        pl[:, : min(2, width // 2)] = edge[: min(2, width // 2)]
        pl[:, width // 2 : width // 2 + min(2, width // 2)] = edge.flip(0)[: min(2, width // 2)]
        return pl

    def ext_values(k):
        return [ext_from_ints([int(x) for x in rng.integers(0, P, size=4)]) for _ in range(k)]

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(ops_instr, nbytes):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_instr / (INT32_LANES * max_sm_mhz * 1e6) * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)

    def check_z1(tag, program, consts, planes, degree, eq=None, reps=3):
        got = dag_dev.round_sums(program, consts, planes, degree, eq)
        want = dag_dev.plain_round_sums(program, consts, planes, degree, eq).cpu()
        err = int((got - want).abs().max())
        if err or got.shape != (degree, len(program.outs)):
            raise AssertionError(f"Z1 {tag}: the kernel's round sums differ from the plain version's")
        rows, width = planes.shape
        c = program.counts
        entry = dict(shape=f"{tag}: {len(program.code)} instructions ({c['mul']} mul, {c['add']} add, "
                           f"{c['sub']} sub, {c['row_reads']} row reads), {program.n_rows} rows, "
                           f"{len(consts.table)} constants, ({rows}, {width}) planes, degree {degree}",
                     max_abs_err=err,
                     ms=event_ms(lambda: dag_dev.round_sums(program, consts, planes, degree, eq), reps),
                     plain_ms=event_ms(lambda: dag_dev.plain_round_sums(program, consts, planes, degree, eq), 1),
                     **bound(width // 2 * degree * (c["mul"] * mul_instr + (c["add"] + c["sub"]) * add_instr),
                             rows * width * 8),
                     build=build_report(program.kernel))
        log(f"phase 9b Z1 {entry['shape']}: kernel == plain (max err {err}); kernel {entry['ms']} ms, "
            f"plain {entry['plain_ms']} ms, bound {entry['bound_ms']} ms by {entry['bound_by']}; {entry['build']}")
        return entry

    def check_z2(tag, planes, groups):
        r4 = ext_values(1)[0].to_ints()
        got = ext4_dev.fold_planes(planes, r4, groups)
        err = int((got - ext4_dev._fold_planes_plain(planes, r4, groups)).abs().max())
        if err:
            raise AssertionError(f"Z2 {tag}: the kernel's fold differs from the plain version's")
        g = groups.table
        rows_read = int((g[:, 0] == 0).sum()) + 4 * int((g[:, 0] == 1).sum())
        width = planes.shape[1]
        entry = dict(shape=f"{tag}: ({planes.shape[0]}, {width}) -> ({got.shape[0]}, {got.shape[1]}), "
                           f"{len(g)} tables",
                     max_abs_err=err, ms=event_ms(lambda: ext4_dev.fold_planes(planes, r4, groups), 10),
                     plain_ms=event_ms(lambda: ext4_dev._fold_planes_plain(planes, r4, groups), 2),
                     **bound(0, (rows_read * width + got.numel()) * 8))
        log(f"phase 9b Z2 {entry['shape']}: kernel == plain (max err {err}); kernel {entry['ms']} ms, "
            f"plain {entry['plain_ms']} ms, bound {entry['bound_ms']} ms by {entry['bound_by']}")
        return entry

    big = max(specs, key=lambda s: s["nodes"])
    small = min(specs, key=lambda s: s["nodes"])
    z1, z2 = [], []
    for spec, widths in ((big, (1 << 20,)), (small, (1 << 20, 64, 2))):
        B, E = len(spec["base_names"]), len(spec["ext_names"])
        G = B + E + 1
        first_groups, ext_groups = fold_groups(B, E)
        alphas = ext_values(spec["num_alphas"])
        programs, sizes = [], []
        for lift, row_of in zip((False, True), spec["row_maps"]):
            tr = trace_combiner_ext(spec["combiner"], spec["base_names"], spec["ext_names"], alphas, P,
                                    lift_base=lift)
            program = compile_device(tr.nodes, tr.outs, row_of)
            programs.append((program, program.constants(tr.consts)))
            sizes.append(len(tr.nodes))
        for width in widths:
            planes0 = planes_of(B + 4 * (E + 1), width)
            z1.append(check_z1(f"{sizes[0]}-node round-0 DAG", *programs[0], planes0, spec["degree"]))
            if spec is big:
                z2.append(check_z2("round-0 layout", planes0, first_groups))
                del planes0
                planes1 = planes_of(4 * G, width // 2)
                z1.append(check_z1(f"{sizes[1]}-node later-round DAG", *programs[1], planes1,
                                   spec["degree"]))
                z2.append(check_z2("all-extension layout", planes1, ext_groups))
                del planes1
            torch.cuda.empty_cache()
    names = ["__idx__", "__sel__", "a", "b", "g"]
    tr = trace_combiner(make_grand_product(*(int(x) for x in rng.integers(1, P, size=2))), names,
                        [int(x) for x in rng.integers(0, P, size=3)], P)
    row_of = {name: i for i, name in enumerate(names)}
    program = compile_device(tr.nodes, [tr.out], row_of)
    z1.append(check_z1("base-field grand product x eq", program, program.constants(tr.consts),
                       planes_of(len(names) + 1, 1 << 20), 4, eq=len(names)))
    torch.cuda.empty_cache()

    # Every distinct program of the prove (equal programs share one kernel)
    # once, at the widest width the prove gives it.
    widest = {}
    for spec in specs:
        B, E = len(spec["base_names"]), len(spec["ext_names"])
        layouts = ((B + 4 * (E + 1), spec["n"]), (4 * (B + E + 1), spec["n"] // 2))
        for program, (rows, width) in zip(spec["programs"], layouts):
            key = dag_dev.prepare(program).key
            if width >= 2 and width > widest.get(key, (0, 0, 0))[2]:
                widest[key] = (spec, program, width, rows)
    every = []
    for spec, program, width, rows in widest.values():
        tr = trace_combiner_ext(spec["combiner"], spec["base_names"], spec["ext_names"],
                                ext_values(spec["num_alphas"]), P, lift_base=program is spec["programs"][1])
        if tr.signature[0] != tuple(program.nodes):
            raise AssertionError("a zerocheck's DAG changed with its challenges")
        every.append(check_z1(f"program {dag_dev.prepare(program).key}", program, program.constants(tr.consts),
                              planes_of(rows, width), spec["degree"], reps=1))
        torch.cuda.empty_cache()
    return {"z1": z1, "z2": z2, "z1_programs": every}


def kernel_ptxas(build_log: str, names) -> dict:
    """ptxas's registers, stack frame and spills of each kernel of ``names``
    (``-Xptxas -v`` in the kernels' build log; empty where the library was
    reused)."""
    from zigz_tpu_torch.ops import _build

    report = {}
    for name in names:
        part = next((part for part in build_log.split("Compiling entry function")[1:]
                     if name in part.splitlines()[0]), "")
        report[name] = _build.ptxas_report(part)
    return report


def poseidon2_unrolled_count(nvcc: str) -> dict:
    """The instructions of one Poseidon2 permutation: nvcc builds
    csrc/poseidon2_kernels.cu once more with P0's round loops unrolled
    (``-DZIGZ_P2_UNROLLED_ROUNDS``) into a cubin under build/, nothing
    launches it, and its P1 (a leaf's framing and one permutation, straight
    line) is counted in ``cuobjdump -sass`` at every address, up to its last
    EXIT, NOPs left out.  Returns the issued instructions, those of each
    pipe of P2_PIPES, the SM clocks a permutation takes at the least (the
    largest of issued / ISSUE_LANES and each pipe's count over its rate),
    the limb that sets it, the opcode counts and nvcc's seconds."""
    from zigz_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = _build.BUILD_DIR / "poseidon2_unrolled.cubin"
    t0 = time.perf_counter()
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-DZIGZ_P2_UNROLLED_ROUNDS", "-cubin", "-o", str(cubin), str(_build.CSRC / "poseidon2_kernels.cu")],
                   capture_output=True, text=True, check=True, timeout=600)
    nvcc_s = time.perf_counter() - t0
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
    count = issue_count(sass, "p2_leaves_kernel")
    if not 5000 < count["issued"] < 40000:
        raise AssertionError(f"implausible count {count['issued']} for one unrolled Poseidon2 permutation in P1's SASS")
    return dict(count, nvcc_s=nvcc_s)


def bound_chain_counts(nvcc: str) -> dict:
    """What one unit of work of a looping kernel issues, from chains of it
    that nothing launches: nvcc builds csrc/measure/bound_chains.cu (not a
    unit of the kernels' library) into a cubin under build/, and
    ``issue_count`` counts each chain in ``cuobjdump -sass`` at every
    address.  ``butterfly``: one butterfly of N1/N2 (csrc/ntt.cuh
    ``butterfly_values``: a Montgomery product, an add and a sub mod p), the
    chains of 64 and 32 butterflies' difference over 32, with no index,
    load or store.  ``block_K4`` and ``block_K5``: one rate block of the
    column sponges (34 row-strided word loads, their XOR into the state and
    one Keccak-f), the chains of 3 and 2 blocks' difference, a block after
    the first, from the zero state with 4 lanes stored (K4) or from 25
    lanes loaded and stored (K5);
    ``column_K4`` and ``column_K5``: the chain of 2 blocks less two blocks,
    the code a column runs once (for K4 less what its first block saves,
    which may leave it below zero).  Each count holds the issued instructions,
    those of each pipe of P2_PIPES, the SM clocks at the least (the largest
    of issued / ISSUE_LANES and each pipe's count over its rate) and the limb
    that sets it; ``nvcc_s`` is nvcc's seconds."""
    from zigz_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = _build.BUILD_DIR / "bound_chains.cubin"
    t0 = time.perf_counter()
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I", str(_build.CSRC),
                    "-cubin", "-o", str(cubin), str(_build.CSRC / "measure" / "bound_chains.cu")],
                   capture_output=True, text=True, check=True, timeout=600)
    nvcc_s = time.perf_counter() - t0
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout

    def per_unit(long: dict, short: dict, units: int) -> dict:
        return with_clocks({k: (long[k] - short[k]) / units for k in ("issued", *P2_PIPES)})

    long, short = (issue_count(sass, "ntt_butterfly_chain_kernel", f"ILi{c}E") for c in (64, 32))
    counts = {"butterfly": dict(per_unit(long, short, 32), opcodes_64=long["opcodes"]), "nvcc_s": nvcc_s}
    if not 6 <= counts["butterfly"]["issued"] <= 40:
        raise AssertionError(f"implausible count {counts['butterfly']['issued']} for one butterfly (chains: "
                             f"{long['issued']}, {short['issued']})")
    for key, carried in (("K4", "Lb0E"), ("K5", "Lb1E")):
        three, two = (issue_count(sass, "sha3_block_chain_kernel", f"ILi{b}E{carried}") for b in (3, 2))
        block = per_unit(three, two, 1)
        column = with_clocks({k: two[k] - 2 * block[k] for k in ("issued", *P2_PIPES)})
        if not 3000 < block["issued"] < 12000 or not -1000 < column["issued"] < 1000:
            raise AssertionError(f"implausible counts for {key}: a block {block['issued']}, a column "
                                 f"{column['issued']} (chains: {three['issued']}, {two['issued']})")
        counts.update({f"block_{key}": dict(block, opcodes_3=three["opcodes"]), f"column_{key}": column})
    return counts


def with_clocks(counts: dict) -> dict:
    """``counts`` (issued instructions and those of each pipe of P2_PIPES)
    with the SM clocks they take at the least, the largest of issued /
    ISSUE_LANES and each pipe's count over its rate, and the limb that sets
    it."""
    clocks = {"issue": counts["issued"] / ISSUE_LANES,
              **{pipe: counts[pipe] / rate for pipe, (_, rate) in P2_PIPES.items()}}
    limb = max(clocks, key=clocks.get)
    return dict(counts, sm_clocks=clocks[limb], limb=limb)


def issue_count(sass: str, *names) -> dict:
    """The instructions one thread of a straight-line kernel issues: the
    first function of ``cuobjdump -sass`` output whose name holds every one
    of ``names``, counted at every address (ALL_SASS_OPCODE) up to its last
    EXIT, NOPs left out.  Returns the issued count, those of each pipe of
    P2_PIPES, the SM clocks a thread takes at the least (the largest of
    issued / ISSUE_LANES and each pipe's count over its rate), the limb
    that sets it and the opcode counts."""
    part = next(part for part in sass.split("Function :")[1:] if all(n in part.splitlines()[0] for n in names))
    opcodes = re.findall(ALL_SASS_OPCODE, part, flags=re.M)
    last_exit = len(opcodes) - 1 - opcodes[::-1].index("EXIT")
    issued = [op for op in opcodes[: last_exit + 1] if op != "NOP"]
    counts = {"issued": len(issued), **{pipe: sum(op in ops for op in issued) for pipe, (ops, _) in P2_PIPES.items()}}
    return dict(with_clocks(counts), opcodes={op: issued.count(op) for op in sorted(set(issued))})


def poseidon2_kernel_phase(dev, max_sm_mhz: float, perm_count: dict, n_leaves: int = 43 << 20,
                           n_e: int = 1 << 19) -> dict:
    """Phase 2's Poseidon2 part: P1 (``p2_leaves``), P2 (``p2_merge``) and P3
    (``p2_absorb``) against their plain versions on the same card tensors
    (byte error 0) and against core/poseidon2.py, at the main path's shapes
    (the leaf level of the 2^20-step v3 forest, its first merge, one
    544-row stream block at n_e = 2^19 from a random carried state), at one
    resident wave of P3's columns (its blocks an SM x SMs x 128, a 544-row
    block) and at the ragged sizes; the column sponge against
    ``_hash_columns``.  Returns the three kernels' entries: byte error,
    kernel and plain ms by CUDA events at the main shapes, the launches of
    one call (the profiler), and the bound, the larger of the bytes over
    3.35 TB/s and the permutations times ``perm_count["sm_clocks"]``
    (poseidon2_unrolled_count) over SM_COUNT SMs at ``max_sm_mhz``; the
    first CUDA version's yardstick (P2_FIRST_VERSION_INSTR) is logged beside it.
    P3's entry also holds the one-wave shape's ms and both shapes' time a
    column."""
    import ctypes

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zigz_tpu_torch.commitments import ligero
    from zigz_tpu_torch.core import poseidon2 as p2_host
    from zigz_tpu_torch.ops import _build, poseidon2

    gen = torch.Generator(device=dev).manual_seed(2)

    def byte_err(a, b) -> int:
        return int((a.view(torch.uint8).to(torch.int16) - b.view(torch.uint8).to(torch.int16)).abs().max())

    def event_ms(fn, x, reps) -> float:
        fn(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def launches_of(fn, x) -> int:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
        return sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)

    def bound(perms, nbytes):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = perms * perm_count["sm_clocks"] / (SM_COUNT * max_sm_mhz * 1e6) * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)

    def canonical(shape):
        """Random canonical int32, its first two values 0 and p - 1."""
        t = torch.randint(0, P, shape, device=dev, dtype=torch.int32, generator=gen)
        edge = torch.tensor([0, P - 1], device=dev, dtype=torch.int32)[: min(2, t.numel())]
        t.view(-1)[: edge.numel()] = edge
        return t

    def host_u64(t):
        return t.cpu().numpy().astype("uint64")

    def np_absorb(state, msg):
        """core/poseidon2.py's sponge steps over carried states, in numpy."""
        s = host_u64(state)
        msg = host_u64(msg)
        for off in range(0, max(msg.shape[0], 1), p2_host.RATE):
            block = msg[off : off + p2_host.RATE]
            s[: block.shape[0]] = (s[: block.shape[0]] + block) % np.uint64(P)
            s = p2_host.np_permute(s)
        return s

    def pairs_of(parents):
        """Child indices 2i, 2i + 1 of each parent i, in order."""
        return torch.stack([2 * parents, 2 * parents + 1], dim=1).reshape(-1)

    def check_p2(tag, leaves_in=None, level=None, state=None, msg=None):
        """Each given kernel call against its plain version on the same card
        tensors (byte error) and against core/poseidon2.py (raises)."""
        errs = []
        if leaves_in is not None:
            got = poseidon2.p2_leaves(leaves_in)
            errs.append(("P1", byte_err(got, poseidon2._p2_leaves_plain(leaves_in))))
            idx = torch.arange(leaves_in.numel(), device=dev) if leaves_in.numel() <= 4097 else torch.cat(
                [torch.arange(4097, device=dev), torch.randint(0, leaves_in.numel(), (64,), generator=gen, device=dev)])
            if poseidon2.limbs_to_bytes(got[:, idx]) != p2_host.np_batch_leaf_hashes(host_u64(leaves_in[idx])):
                raise AssertionError(f"P1 {tag}: digests differ from core/poseidon2.py")
        if level is not None:
            got = poseidon2.p2_merge(level)
            errs.append(("P2", byte_err(got, poseidon2._p2_merge_plain(level))))
            parents = got.shape[1]
            idx = torch.arange(parents, device=dev) if parents <= 4097 else torch.cat(
                [torch.arange(4097, device=dev), torch.randint(0, parents, (64,), generator=gen, device=dev)])
            children = poseidon2.limbs_to_bytes(level[:, pairs_of(idx)])
            if poseidon2.limbs_to_bytes(got[:, idx]) != p2_host.np_batch_merge_hashes(children):
                raise AssertionError(f"P2 {tag}: digests differ from core/poseidon2.py")
        if state is not None:
            got = poseidon2.p2_absorb(state.clone(), msg)
            errs.append(("P3", byte_err(got, poseidon2._p2_absorb_plain(state.clone(), msg))))
            n = state.shape[1]
            cols = torch.arange(n, device=dev) if n <= 4097 else torch.cat(
                [torch.tensor([0, 1, n - 1], device=dev), torch.randint(0, n, (8,), generator=gen, device=dev)])
            if not (host_u64(got[:, cols]) == np_absorb(state[:, cols], msg[:, cols])).all():
                raise AssertionError(f"P3 {tag}: the state differs from core/poseidon2.py's sponge steps")
        return errs

    # The main path's shapes: the leaf level of the 2^20-step v3 forest, its
    # first merge, one 544-row stream block at n_e = 2^19 from a random
    # carried state; then the ragged sizes.
    p2_vals = canonical((n_leaves,))
    p2_level = canonical((8, n_leaves))
    p2_state = canonical((16, n_e))
    p2_block = canonical((544, n_e))
    p2_errs = check_p2("main shapes", p2_vals, p2_level, p2_state, p2_block)
    blocks = ctypes.c_int(0)
    _build.check(_build.load().lib.zigz_p2_absorb_blocks_per_sm(ctypes.byref(blocks)),
                 "zigz_p2_absorb_blocks_per_sm")
    n_wave = blocks.value * torch.cuda.get_device_properties(dev).multi_processor_count * 128
    wave_state, wave_block = canonical((16, n_wave)), canonical((544, n_wave))
    p2_errs += check_p2(f"one wave of P3, {n_wave} columns", state=wave_state, msg=wave_block)
    # a level of 3 trees of 64 leaves, as a tree-major forest merges it
    p2_errs += check_p2("3 trees", level=canonical((8, 3, 64)).view(8, -1))
    for n in (1, 2, 31, 33, 127, 129, 255, 4097):
        p2_errs += check_p2(f"n={n}", canonical((n,)), canonical((8, 2 * n)))
        if n in (1, 31, 33, 255, 4097):
            for rows in (0, 1, 7, 8, 9, 543, 544, 545):
                p2_errs += check_p2(f"({rows}, {n})", state=canonical((16, n)), msg=canonical((rows, n)))
    p2_err = {k: max(e for name, e in p2_errs if name == k) for k in ("P1", "P2", "P3")}
    if any(p2_err.values()):
        raise AssertionError(f"the Poseidon2 kernels disagree with their plain versions: byte errors {p2_err}")
    for r, n in ((1, 1), (13, 256), (545, 128), (1100, 8)):
        mat = canonical((r, n))
        want = ligero._hash_columns(ligero.ntt_pow2_u32(host_u64(mat), 8 * n), "poseidon2")
        if poseidon2.limbs_to_bytes(poseidon2.p2_columns_stream(mat, 8 * n)) != want:
            raise AssertionError(f"the Poseidon2 column sponge differs from _hash_columns at ({r}, {n})")
    log("phase 2 Poseidon2: P1, P2, P3 == their plain versions (max byte err "
        f"{p2_err}) and == core/poseidon2.py at the main shapes, at one resident wave of P3 ({blocks.value} blocks an "
        f"SM, {n_wave} columns x 544 rows), P1 and P2 at 1, 2, 31, 33, 127, 129, 255, 4097 hashes and parents and a "
        "level of 3 trees, P3 at 1, 31, 33, 255, 4097 columns x 0, 1, 7, 8, 9, 543, 544, 545 rows; the column sponge "
        "(P3) == _hash_columns(poseidon2) at (1, 1), (13, 256), (545, 128), (1100, 8) rows x columns")

    results = {}
    p2_scratch = p2_state.clone()
    for key, tag, shape, fn, plain, x, perms, nbytes in (
            ("p2_leaves", "P1", f"({n_leaves},) -> (8, {n_leaves}) [2^20-step v3 forest leaves]",
             poseidon2.p2_leaves, poseidon2._p2_leaves_plain, p2_vals, n_leaves, n_leaves * (4 + 32)),
            ("p2_merge", "P2", f"(8, {n_leaves}) -> (8, {n_leaves // 2}) [its first merge level]",
             poseidon2.p2_merge, poseidon2._p2_merge_plain, p2_level, n_leaves, n_leaves // 2 * (64 + 32)),
            ("p2_absorb", "P3", f"state (16, {n_e}) + (544, {n_e}) rows, 68 permutations a column",
             lambda s: poseidon2.p2_absorb(s, p2_block), lambda s: poseidon2._p2_absorb_plain(s, p2_block),
             p2_scratch, 68 * n_e, n_e * (2 * 16 * 4 + 544 * 4))):
        results[key] = dict(max_abs_err=p2_err[tag], shape=shape, ms=event_ms(fn, x, 10),
                            plain_ms=event_ms(plain, x, 1), launches_a_call=launches_of(fn, x),
                            **bound(perms, nbytes))
        r = results[key]
        first_ms = perms * P2_FIRST_VERSION_INSTR / (INT32_LANES * max_sm_mhz * 1e6) * 1e3
        log(f"phase 2 {key} ({tag}): {shape}: kernel {r['ms']} ms ({r['launches_a_call']} launch a call), plain "
            f"{r['plain_ms']} ms, bound {r['bound_ms']} ms by {r['bound_by']} ({perms} permutations x "
            f"{perm_count['sm_clocks']} SM clocks, set by {perm_count['limb']}: {r['bound_ms'] / r['ms']:.1%}); "
            f"for comparison only, the first version's yardstick ({P2_FIRST_VERSION_INSTR} instructions over the INT32 "
            f"lanes) {first_ms} ms ({first_ms / r['ms']:.1%})")
    wave_scratch = wave_state.clone()
    p3 = results["p2_absorb"]
    p3.update(wave_shape=f"state (16, {n_wave}) + (544, {n_wave}) rows: one resident wave ({blocks.value} blocks an SM)",
              wave_ms=event_ms(lambda s: poseidon2.p2_absorb(s, wave_block), wave_scratch, 10),
              wave_bound_ms=bound(68 * n_wave, n_wave * (2 * 16 * 4 + 544 * 4))["bound_ms"])
    p3.update(us_a_column_wave=p3["wave_ms"] * 1e3 / n_wave, us_a_column_main=p3["ms"] * 1e3 / n_e)
    log(f"phase 2 p2_absorb (P3) at one resident wave: {p3['wave_shape']}: {p3['wave_ms']} ms, "
        f"{p3['us_a_column_wave']} us a column against {p3['us_a_column_main']} at {n_e} columns")
    del p2_vals, p2_level, p2_state, p2_block, p2_scratch, wave_state, wave_block, wave_scratch
    torch.cuda.empty_cache()
    return results



def field64_kernel_phase(dev, max_sm_mhz: float, counts: dict, build_log: str) -> dict:
    """Phase 2c: E1 (``field64.fold_lsb_u64``, csrc/field64_kernels.cu over
    csrc/field64.cuh) against its plain version ``_fold_lsb_u64_plain`` on
    the same card tensors, over Goldilocks and Mersenne61: every fold of
    the (43, 2^22) and (43, 2^10) evaluations (so every width from 2^22
    down to 2), one row of 2^10, single folds at (1, 2), (3, 6) and
    (5, 510) (ragged blocks), and v = 0 (no launch); values and challenges
    random canonical with 0, 1, p - 1, p - 2 and, over Goldilocks, 2^63 and
    p - 2^32 (both 2^63 or more, negative as int64) among them.  Byte error
    must be 0.  Times by CUDA events: the whole (43, 2^22) evaluation (22
    launches) and its first fold alone, kernel and plain.  The bound: the
    bytes (each fold's input and challenges read once, its output written
    once) over 3.35 TB/s against the outputs x the SM clocks one thread of
    the field's instantiation takes (``counts``, from ``issue_count``) over
    SM_COUNT SMs at ``max_sm_mhz``.  No PyTorch call computes a 64-bit
    modular fold (``library_ms`` null).  Returns an entry a field, with
    ptxas's registers and spills of its instantiation."""
    import torch

    from zigz_tpu_torch.ops import _build, field64

    gen = torch.Generator(device=dev).manual_seed(3)

    def byte_err(a, b) -> int:
        return int((a.view(torch.uint8).to(torch.int16) - b.view(torch.uint8).to(torch.int16)).abs().max())

    def event_ms(fn, reps) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bits(v: int) -> int:
        return v - (1 << 64) if v >= 1 << 63 else v

    def canonical(shape, p):
        """Random canonical u64 bits as int64, the edge values first."""
        if p == field64.GOLDILOCKS_P:
            x = torch.randint(-(1 << 63), (1 << 63) - 1, shape, dtype=torch.int64, device=dev, generator=gen)
            # the bits of p .. 2^64 - 1 are the int64 values -(2^32 - 1) .. -1: fold them below 2^32
            x = torch.where((x < 0) & (x > -(1 << 32)), x & 0xFFFFFFFF, x)
            edges = [0, 1, p - 1, p - 2, 1 << 63, p - (1 << 32)]
        else:
            x = torch.randint(0, p, shape, dtype=torch.int64, device=dev, generator=gen)
            edges = [0, 1, p - 1, p - 2]
        flat = x.view(-1)
        k = min(len(edges), flat.numel())
        flat[:k] = torch.tensor([bits(v) for v in edges[:k]], dtype=torch.int64, device=dev)
        return x

    def every_fold(matrix, points, p) -> int:
        """Each fold of an evaluation against the plain fold of the same
        input, then the evaluation against the last fold's value."""
        err, cur = 0, matrix
        for j in range(points.shape[1]):
            r = points[:, j].contiguous()
            out = field64.fold_lsb_u64(cur, r, p)
            err = max(err, byte_err(out, field64._fold_lsb_u64_plain(cur, r, p)))
            cur = out
        return max(err, byte_err(field64.batch_eval_lsb_u64(matrix, points, p), cur[:, 0]))

    def plain_eval(matrix, points, p):
        """The plain version of the whole evaluation: one plain fold a variable."""
        cur = matrix
        for j in range(points.shape[1]):
            cur = field64._fold_lsb_u64_plain(cur, points[:, j].contiguous(), p)
        return cur[:, 0]

    def bound(outputs: int, nbytes: int, clocks: float) -> dict:
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = outputs * clocks / (SM_COUNT * max_sm_mhz * 1e6) * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=None)

    def eval_work(b: int, width: int) -> tuple:
        """(outputs, bytes) of the whole evaluation of b rows of ``width``."""
        outputs = nbytes = 0
        while width > 1:
            outputs += b * (width // 2)
            nbytes += b * (width + 1 + width // 2) * 8
            width //= 2
        return outputs, nbytes

    results = {}
    rows, log2_width = 43, 22
    n = 1 << log2_width
    for name, p in (("Goldilocks", field64.GOLDILOCKS_P), ("Mersenne61", field64.MERSENNE61_P)):
        count = counts[name]
        err = 0
        for b, v in ((rows, 10), (1, 10), (rows, 0)):
            err = max(err, every_fold(canonical((b, 1 << v), p), canonical((b, v), p), p))
        for b, w in ((1, 2), (3, 6), (5, 510)):
            x, r = canonical((b, w), p), canonical((b,), p)
            err = max(err, byte_err(field64.fold_lsb_u64(x, r, p), field64._fold_lsb_u64_plain(x, r, p)))
        matrix, points = canonical((rows, n), p), canonical((rows, log2_width), p)
        err = max(err, every_fold(matrix, points, p))
        if err:
            raise AssertionError(f"E1 over {name} disagrees with its plain version: byte error {err}")
        r0 = points[:, 0].contiguous()
        outputs, nbytes = eval_work(rows, n)
        entry = dict(
            max_abs_err=err, shape=f"({rows}, 2^{log2_width}) -> ({rows},), {log2_width} folds [the v1 2^{log2_width} "
                                   f"openings' evaluation over {name}]",
            ms=event_ms(lambda: field64.batch_eval_lsb_u64(matrix, points, p), 20),
            plain_ms=event_ms(lambda: plain_eval(matrix, points, p), 1),
            **bound(outputs, nbytes, count["sm_clocks"]),
            first_fold=dict(shape=f"({rows}, 2^{log2_width}) -> ({rows}, 2^{log2_width - 1})",
                            ms=event_ms(lambda: field64.fold_lsb_u64(matrix, r0, p), 20),
                            plain_ms=event_ms(lambda: field64._fold_lsb_u64_plain(matrix, r0, p), 2),
                            **bound(rows * n // 2, rows * (n + 1 + n // 2) * 8, count["sm_clocks"])),
            instructions_an_output={k: count[k] for k in ("issued", "ALU", "FMA", "sm_clocks", "limb")},
            ptxas=_build.ptxas_report(next((part for part in build_log.split("Compiling entry function")[1:]
                                            if "mle_fold_u64_kernel" in part.splitlines()[0]
                                            and name in part.splitlines()[0]), "")))
        first = entry["first_fold"]
        log(f"phase 2c E1 over {name}: kernel == plain (max byte err {err}) at every fold of ({rows}, 2^{log2_width}) "
            f"and ({rows}, 2^10), (1, 2^10), v = 0, and single folds at (1, 2), (3, 6), (5, 510), edge values "
            f"among values and challenges; {entry['shape']}: kernel {entry['ms']} ms, plain {entry['plain_ms']} ms, "
            f"bound {entry['bound_ms']} ms by {entry['bound_by']} ({nbytes} B; {outputs} outputs x "
            f"{count['sm_clocks']} SM clocks, set by {count['limb']}: {entry['ops_ms']} ms), "
            f"{entry['bound_ms'] / entry['ms']:.1%} of it; first fold {first['shape']}: kernel {first['ms']} ms, "
            f"plain {first['plain_ms']} ms, bound {first['bound_ms']} ms ({first['bound_ms'] / first['ms']:.1%}); "
            f"ptxas {entry['ptxas']}; {count['issued']} instructions an output ({count['ALU']} ALU pipe, "
            f"{count['FMA']} IMAD)")
        results[name] = entry
        del matrix, points, r0
        torch.cuda.empty_cache()
    return results


def ntt_kernel_phase(dev, max_sm_mhz: float, butterfly: dict, build_log: str) -> dict:
    """Phase 2d: N1 and N2, the Reed-Solomon row encode (``ntt_dev.encode_rows``,
    csrc/ntt_kernels.cu over csrc/ntt.cuh), against its plain version
    ``_encode_rows_plain`` on the same card tensors, byte error 0, at the
    main path's shapes, (544, 2^16) -> 2^19 (a stream block of the v2-v4
    2^20 commits), (544, 2^17) -> 2^20 (the same at 2^22 steps, where
    ``choose_split_mixed`` gives n = 2^17) and (688, 2^16) -> 2^19
    (``ligero_commit_device`` of the 43 witness MLEs at 2^20); at the shapes
    whose global stages take N2 two passes, (3, 2^20) -> 2^22 (5 + 4) and
    (1, 2^14) -> 2^27 (7 + 7), and one of 8 stages after a broadcast-only
    N1, (1, 2^8) -> 2^27; and at R in {0, 1, 33, 545} rows x n_out in {2,
    2^12, 2^13, 2^14} x n in {1, n_out / 8, n_out}, the values 0 and p - 1
    first in every matrix; each call's launches are N1 once and N2 once a
    pass of ``n2_passes``.  At the main shapes and the two-pass ones: the
    whole encode, N1 alone and each N2 pass by CUDA events, the plain
    version's ms, and the bounds: the butterflies x the SM clocks of one
    butterfly's arithmetic (``butterfly``, from bound_chain_counts) over
    SM_COUNT SMs at ``max_sm_mhz``, against the bytes: the whole encode and
    N1 read the coefficients and their twiddles once and write the output
    once; an N2 pass does every butterfly of its stages and reads and writes
    the output once, with its stages' twiddles.  No PyTorch call computes a
    BabyBear NTT (``library_ms`` null).  Returns the entries ``ntt`` (the
    whole encode at each timed shape), ``n1``, ``n2`` (the first main shape)
    and ``ptxas``."""
    import torch

    from zigz_tpu_torch.ops import ntt_dev

    gen = torch.Generator(device=dev).manual_seed(13)
    clock_ms = 1e3 / (SM_COUNT * max_sm_mhz * 1e6)

    def coefficients(r, n):
        t = torch.randint(0, P, (r, n), device=dev, dtype=torch.int32, generator=gen)
        edge = torch.tensor([0, P - 1], device=dev, dtype=torch.int32)[: min(2, t.numel())]
        t.view(-1)[: edge.numel()] = edge
        return t

    def byte_err(a, b) -> int:
        if a.numel() == 0 and b.numel() == 0:
            return 0
        return int((a.view(torch.uint8).to(torch.int16) - b.view(torch.uint8).to(torch.int16)).abs().max())

    def event_ms(fn, reps) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(butterflies, nbytes):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = butterflies * butterfly["sm_clocks"] * clock_ms
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)

    def check(r, n, n_out):
        """encode_rows on the card == the plain version (byte error), with
        N1's launch and N2's for each pass of n2_passes."""
        mat = coefficients(r, n)
        before = dict(ntt_dev.LAUNCHES)
        got = ntt_dev.encode_rows(mat, n_out)
        launched = (ntt_dev.LAUNCHES["tile"] - before["tile"], ntt_dev.LAUNCHES["pass"] - before["pass"])
        want = (1, len(ntt_dev.n2_passes(n, n_out))) if r else (0, 0)
        if launched != want or tuple(got.shape) != (r, n_out) or got.dtype != torch.int32:
            raise AssertionError(f"encode_rows ({r}, {n}) -> {n_out}: launches {launched}, not {want}, or "
                                 f"{got.dtype} {tuple(got.shape)}")
        err = byte_err(got, ntt_dev._encode_rows_plain(mat, n_out))
        del got
        return mat, err

    err = 0
    for r in (0, 1, 33, 545):
        for n_out in (2, 1 << 12, 1 << 13, 1 << 14):  # the tile of 2^13 outputs, its half and its double
            for n in sorted({1, max(1, n_out // 8), n_out}):
                err = max(err, check(r, n, n_out)[1])
    log(f"phase 2d N1/N2: encode_rows == _encode_rows_plain (max byte err {err}) at 0, 1, 33, 545 rows x n_out 2, "
        f"2^12, 2^13, 2^14 x n 1, n_out / 8, n_out, with 0 and p - 1 among the values")

    results = {"ntt": []}
    for r, n, n_out, what in ((544, 1 << 16, 1 << 19, "a stream block of the v2-v4 2^20 commits"),
                              (544, 1 << 17, 1 << 20, "a stream block at 2^22 steps"),
                              (688, 1 << 16, 1 << 19, "ligero_commit_device, 43 MLEs at 2^20"),
                              (3, 1 << 20, 1 << 22, "N2 in two passes"),
                              (1, 1 << 14, 1 << 27, "the largest subgroup, N2 in two passes"),
                              (1, 1 << 8, 1 << 27, "the largest subgroup, N1 a broadcast, N2 one pass of 8")):
        mat, err_here = check(r, n, n_out)
        err = max(err, err_here)
        log_k = (n_out // n).bit_length() - 1
        log_out = n_out.bit_length() - 1
        passes = ntt_dev.n2_passes(n, n_out)
        first = passes[0].start if passes else log_out  # N1 runs stages log_k .. first - 1
        tw = ntt_dev._mont_twiddles(n_out, dev)
        out = torch.empty((r, n_out), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        half = r * n_out // 2
        reps = 10 if r > 1 else 3
        entry = dict(
            max_abs_err=err_here, shape=f"({r}, {n}) -> ({r}, {n_out}) [{what}]",
            ms=event_ms(lambda: ntt_dev.encode_rows(mat, n_out), reps),
            plain_ms=event_ms(lambda: ntt_dev._encode_rows_plain(mat, n_out), 2),
            launches_a_call=1 + len(passes),
            n1_ms=event_ms(lambda: ntt_dev._launch_tile(mat, tw, out, stream), reps),
            n2_ms=[event_ms(lambda: ntt_dev._launch_pass(out, tw, stages, stream), reps) for stages in passes],
            n1_stages=[log_k, first - 1] if log_k < first else None,
            n2_passes=[[stages[0], stages[-1]] for stages in passes],
            butterflies=half * max(0, log_out - log_k),
            **bound(half * max(0, log_out - log_k), 4 * (r * n + n_out - 1 + r * n_out)))
        n1 = bound(half * max(0, first - log_k), 4 * (r * n + (1 << first) - 1 + r * n_out))
        n2 = [bound(half * len(stages), 4 * (2 * r * n_out + (1 << stages.stop) - (1 << stages.start)))
              for stages in passes]
        entry.update(n1_bound_ms=n1["bound_ms"], n1_bound_by=n1["bound_by"],
                     n2_bound_ms=[b["bound_ms"] for b in n2], n2_bound_by=[b["bound_by"] for b in n2])
        results["ntt"].append(entry)
        log(f"phase 2d N1/N2 {entry['shape']}: kernel == plain (byte err {err_here}); encode {entry['ms']} ms in "
            f"{entry['launches_a_call']} launches (N1 {entry['n1_ms']} ms, stages {entry['n1_stages']}, bound "
            f"{entry['n1_bound_ms']} ms by {entry['n1_bound_by']}: {entry['n1_bound_ms'] / entry['n1_ms']:.1%}; N2 "
            f"{entry['n2_ms']} ms, passes {entry['n2_passes']}, bounds {entry['n2_bound_ms']} ms by "
            f"{entry['n2_bound_by']}: {[f'{b / t:.1%}' for b, t in zip(entry['n2_bound_ms'], entry['n2_ms'])]}), "
            f"plain {entry['plain_ms']} ms; bound {entry['bound_ms']} ms by {entry['bound_by']} "
            f"({entry['butterflies']} butterflies x {butterfly['sm_clocks']} SM clocks, set by {butterfly['limb']}: "
            f"{entry['bound_ms'] / entry['ms']:.1%})")
        del mat, out
        torch.cuda.empty_cache()
    if err:
        raise AssertionError(f"N1/N2 disagree with their plain version: byte error {err}")
    results["ptxas"] = kernel_ptxas(build_log, NTT_KERNELS.values())
    for name, report in results["ptxas"].items():
        log(f"phase 2d ptxas {name}: {report['registers']} registers, stack frame {report['stack_frame_B']} B, "
            f"spill stores {report['spill_stores_B']} B, spill loads {report['spill_loads_B']} B")
    main = results["ntt"][0]
    results["n1"] = dict(main, ms=main["n1_ms"], bound_ms=main["n1_bound_ms"], bound_by=main["n1_bound_by"])
    results["n2"] = dict(main, ms=main["n2_ms"][0], bound_ms=main["n2_bound_ms"][0], bound_by=main["n2_bound_by"][0])
    return results


def witness_kernel_phase(dev, build_log: str) -> dict:
    """Phase 2e: W1 (``witness_dev.witness_rows``, csrc/witness_kernels.cu
    over csrc/witness.cuh; it stands for the non-register rows of the JAX
    package's ``_build_witness_jit`` and its host ``pack_trace_columns``)
    against its plain version ``_witness_rows_plain`` on the same card
    tensors, over BabyBear, Goldilocks and Mersenne61: raw columns of 777
    steps in 2^10 rows and of 4,190,000 steps in 2^22 (the v1-fib-2e22
    cell's shape), with the edge values of tests/torch_witness_cases.py
    ``raw_columns`` among them; byte error 0, each call one launch over its
    real steps; then one ``build_witness`` of each edge trace of that file
    on the card, one launch each and the witness of the CPU's plain path.
    Times by CUDA events at the 2^22 shape: W1, the plain version, and the
    register fill that reads W1's outputs.  The bound: the bytes, the raw
    columns read once (48 B a real step) and rows 0, 33-42, the write value
    and the write index written once, over 3.35 TB/s.  No PyTorch call
    computes these rows (``library_ms`` null).  Returns an entry a field,
    with ptxas's registers and spills of its instantiation."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_witness_cases import EDGE_CASES, raw_columns
    from zigz_tpu_torch import BabyBear, Goldilocks, Mersenne61
    from zigz_tpu_torch.ops import _build, witness_dev
    from zigz_tpu_torch.runtime import native_vm

    def event_ms(fn, reps) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def byte_err(a, b) -> int:
        return int((a.view(torch.uint8).to(torch.int16) - b.view(torch.uint8).to(torch.int16)).abs().max())

    instances = {"BabyBear": "Narrow", "Goldilocks": "Goldilocks", "Mersenne61": "Mersenne61"}
    results = {}
    for name, field in (("BabyBear", BabyBear), ("Goldilocks", Goldilocks), ("Mersenne61", Mersenne61)):
        p = field.MODULUS
        wide = p >= 1 << 31
        dtype, word = (torch.int64, 8) if wide else (torch.int32, 4)
        err = 0
        for n_real, n in ((777, 1 << 10), (4_190_000, 1 << 22)):
            cols = {k: torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a).to(dev)
                    for k, a in raw_columns(n_real, seed=n_real).items()}
            last_pc = int(cols["pc"][-1]) & ((1 << 64) - 1)
            got = torch.full((43, n), 7, dtype=dtype, device=dev)
            want = got.clone()
            before = dict(witness_dev.ROWS)
            got_val, got_idx = witness_dev.witness_rows(cols, n_real, last_pc, got, p)
            torch.cuda.synchronize()
            if witness_dev.ROWS != {"launches": before["launches"] + 1, "steps": before["steps"] + n_real}:
                raise AssertionError(f"W1 over {name}: counters {witness_dev.ROWS} after {before}")
            want_val, want_idx = witness_dev._witness_rows_plain(cols, n_real, last_pc, want, p)
            err = max(err, byte_err(got, want), byte_err(got_val, want_val), byte_err(got_idx, want_idx))
        if err:
            raise AssertionError(f"W1 over {name} disagrees with its plain version: byte error {err}")
        nbytes = 48 * n_real + (11 * word + word + 1) * n
        rows = torch.empty((43, n), dtype=dtype, device=dev)
        wr_val, wr_idx = witness_dev.witness_rows(cols, n_real, last_pc, rows, p)
        regs = torch.zeros(32, dtype=dtype, device=dev)
        entry = dict(
            max_abs_err=err, shape=f"{n_real:,} steps -> (43, 2^22) rows 0, 33-42 [the v1-fib-2e22 witness over {name}]",
            ms=event_ms(lambda: witness_dev.witness_rows(cols, n_real, last_pc, rows, p), 20),
            plain_ms=event_ms(lambda: witness_dev._witness_rows_plain(cols, n_real, last_pc, rows, p), 2),
            register_fill_ms=event_ms(lambda: witness_dev._fill_registers(rows, wr_val, wr_idx, regs), 5),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes, library_ms=None,
            ptxas=_build.ptxas_report(next((part for part in build_log.split("Compiling entry function")[1:]
                                            if "witness_rows_kernel" in part.splitlines()[0]
                                            and instances[name] in part.splitlines()[0]), "")))
        log(f"phase 2e W1 over {name}: kernel == plain (max byte err {err}) at 777 steps in 2^10 rows and "
            f"{entry['shape']}, one launch a call; kernel {entry['ms']} ms, plain {entry['plain_ms']} ms, bound "
            f"{entry['bound_ms']} ms by bytes ({nbytes} B), {entry['bound_ms'] / entry['ms']:.1%} of it; the "
            f"register fill after it {entry['register_fill_ms']} ms; ptxas {entry['ptxas']}")
        results[name] = entry
        del cols, got, want, rows, wr_val, wr_idx
        torch.cuda.empty_cache()
    launches = {}
    for case, make in EDGE_CASES.items():
        spec = make()
        nvm = native_vm.NativeVM()
        nvm.load_segment(0x1000, spec["program"])
        trace = nvm.run(0x1000, 10000, spec["initial_regs"], None)["trace"]
        num_vars = max(0, (trace.step_count() - 1).bit_length())
        before = witness_dev.ROWS["launches"]
        lo = witness_dev.build_witness(trace, trace.initial_regs, num_vars, dev)
        launches[case] = witness_dev.ROWS["launches"] - before
        if launches[case] != 1 or not torch.equal(lo.cpu(), witness_dev.build_witness(
                trace, trace.initial_regs, num_vars, "cpu")):
            raise AssertionError(f"build_witness of {case} on the card: {launches[case]} launches of W1, or a "
                                 "witness other than the CPU's")
    log(f"phase 2e build_witness on the card: one launch of W1 and the CPU's witness for {sorted(launches)}")
    results["build_witness_launches"] = launches
    return results


def wide_field_phases(dev, pinned) -> dict:
    """Phases 4c and 5b: v1 over Goldilocks and Mersenne61 through
    ``Prover(F, device=dev)``.  4c: NOP at 2^16 and 2^20 steps and the
    wide-value guest (tests/torch_wide_guest.py, its code in the pin) in
    each field, equal to the pins made by zigz_tpu's host path and verified
    Accept by the port; E1 launched once a variable, K1 once and K2 once a
    level.  5b, the slice's full-width run: NOP at 2^22 steps in each
    field, two passes in this process with equal bytes, Accept, total_s
    and the phase split, and the peak device memory allocated and reserved.
    Returns ``{"launches": {case: {"E1", "K1", "K2"}}, "full_width": {case:
    figures}}``, the 2^22 cases in both."""
    import torch

    import zigz_tpu_torch as zt
    from zigz_tpu_torch.ops import field64, keccak

    def prove(field, program, max_steps):
        keccak.LAUNCHES.update(leaves=0, merge=0)
        field64.LAUNCHES.update(fold=0)
        prover = zt.Prover(field, seed=0, device=dev)
        data = zt.serialization.BinarySerializer(field).serialize(prover.prove(program, 0x1000, None, max_steps,
                                                                               None, None))
        counts = {"E1": field64.LAUNCHES["fold"], "K1": keccak.LAUNCHES["leaves"], "K2": keccak.LAUNCHES["merge"]}
        v = prover.last_timings["num_vars"]
        if counts != {"E1": v, "K1": 1, "K2": v}:
            raise AssertionError(f"{field.MODULUS}: launches {counts} are not E1 {v}, K1 1, K2 {v}")
        return data, prover, counts

    def accept(field, data, program):
        ser = zt.serialization.BinarySerializer(field)
        verdict = zt.Verifier(field).verify(ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's proof over p = {field.MODULUS} was rejected: {verdict}")

    out = {"launches": {}, "full_width": {}}
    for name, cases in (
            ("Goldilocks", ("v1-goldilocks-nop-2^16", "v1-goldilocks-nop-2^20", "v1-goldilocks-wide-values")),
            ("Mersenne61", ("v1-mersenne61-nop-2^16", "v1-mersenne61-nop-2^20", "v1-mersenne61-wide-values"))):
        field = getattr(zt.core.field, name)
        for case in cases:
            pin = pinned[case]
            spec = pin["program"]
            program = NOP * spec["count"] if spec["kind"] == "nop" else bytes.fromhex(spec["hex"])
            data, prover, counts = prove(field, program, pin["max_steps"])
            got = (prover.last_timings["num_steps"], len(data), sha(data))
            if got != (pin["num_steps"], pin["bytes"], pin["sha256"]):
                raise AssertionError(f"{case}: (steps, bytes, sha256) {got} differ from the pinned "
                                     f"{(pin['num_steps'], pin['bytes'], pin['sha256'])}")
            accept(field, data, program)
            out["launches"][case] = counts
            log(f"phase 4c {case}: p = {field.MODULUS}, steps {got[0]} sha256 {got[2][:16]} == pinned, {got[1]} B, "
                f"Accept, launches {counts}, total_s {prover.last_timings['total_s']}")
    keys = ("total_s", "execute_s", "witness_dev_s", "forest_s", "evals_s", "opens_s", "sumcheck_lasso_s",
            "commitments_s", "forest_plan")
    program = NOP * (1 << 22)
    for name in ("Goldilocks", "Mersenne61"):
        field = getattr(zt.core.field, name)
        case = f"v1-{name.lower()}-nop-2^22"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        passes, first = [], None
        for _ in range(2):
            data, prover, counts = prove(field, program, 1 << 23)
            passes.append((sha(data), len(data), counts, {k: prover.last_timings[k] for k in keys}))
            first = first or data
            del data
        if passes[0][:3] != passes[1][:3]:
            raise AssertionError(f"{case}: the two passes differ: {[p[:3] for p in passes]}")
        peaks = {"allocated_B": torch.cuda.max_memory_allocated(dev), "reserved_B": torch.cuda.max_memory_reserved(dev)}
        accept(field, first, program)
        out["launches"][case] = passes[0][2]
        out["full_width"][case] = dict(sha256=passes[0][0], bytes=passes[0][1], timings=[p[3] for p in passes],
                                       peak=peaks)
        log(f"phase 5b {case}: two passes sha256 {passes[0][0][:16]} equal, {passes[0][1]} B, Accept, launches "
            f"{passes[0][2]}, peak device memory {peaks['allocated_B']} B allocated, {peaks['reserved_B']} B "
            f"reserved")
        for i, (_, _, _, t) in enumerate(passes):
            log(f"  pass {i + 1}: " + " ".join(f"{k}={t[k]}" for k in keys)
                + f" steps_per_s={(1 << 22) / t['total_s']}")
        del first, prover
    torch.cuda.empty_cache()
    return out


def build_report(build) -> dict:
    """A generated kernel's build: nvcc seconds in this process (0 when the
    library was reused), registers and spill bytes a thread (ptxas)."""
    from zigz_tpu_torch.ops import _build

    build.wait()
    return dict(key=build.key, nvcc_s=build.build_s, **_build.ptxas_report(build.log))


def group_phases(pinned) -> dict:
    """Phases 14 and 15; returns the per-rank kernel launches of the two
    sharded proves, by pinned case."""
    import shutil
    import tempfile

    import torch

    from zigz_tpu_torch.ops import ntt_dev
    from zigz_tpu_torch.parallel.launch import LaunchFailed, launch

    # -- phases 14, 15: the sharded prover, two ranks sharing the card ------
    # A rank is this script started again with --rank: jax and zigz_tpu are
    # blocked there too, before the port is imported.  Both ranks name
    # cuda:0 and use gloo as the transport (NCCL refuses two ranks on one
    # GPU), so every collective is staged through the host.  The two ranks
    # time-share the card: their figures are printed as what they are and
    # compared with nothing.
    rank_command = [sys.executable, os.path.abspath(__file__), "--rank"]
    jobs_dir = tempfile.mkdtemp(prefix="chip_smoke_jobs_", dir=os.path.join(ROOT, "build"))
    torch.cuda.empty_cache()

    def on_two_ranks(function, spec, timeout_s):
        results = launch(2, function, spec, work_dir=jobs_dir, device="cuda:0", backend="gloo",
                         timeout_s=timeout_s, command=rank_command)
        if [r["rank"] for r in results] != [0, 1] or any(r["device"] != "cuda:0" for r in results):
            raise AssertionError(f"the ranks did not run on cuda:0: {[(r['rank'], r['device']) for r in results]}")
        return results

    t0 = time.perf_counter()
    pieces = on_two_ranks("checks", {"checks": [
        {"name": "wrappers", "kind": "wrappers", "seed": 14},
        {"name": "dist_sumcheck 2^20", "kind": "dist_sumcheck", "seed": 14, "log2_n": 20},
        {"name": "device_prove_step (43, 2^20)", "kind": "prove_step", "seed": 15, "B": 43, "v": 20},
        {"name": f"commit_columns_mesh {V2_DATA_ROWS} x 2^16 -> 2^19", "kind": "commit", "seed": 16,
         "rows": V2_DATA_ROWS, "n": 1 << 16, "n_e": 1 << 19, "n_gather": 64},
        {"name": "prove_rounds_mesh 20, 20, 18, 16, 10 variables", "kind": "batch_eval", "seed": 17,
         "log2_sizes": [20, 20, 18, 16, 10]},
        {"name": "forest (43, 2^16) freed levels, three groups", "kind": "forest", "seed": 18, "B": 43, "v": 16,
         "discard_digests": (43 << 16) >> 3, "group_leaf_digests": 16 << 15},
    ]}, timeout_s=600)
    for res in pieces:
        for name, check in res["results"].items():
            if name == "wrappers":
                if not (check["rows_to_columns_ok"] and check["gather_cyclic_ok"] and check["gather_last_ok"]
                        and check["all_reduce"] == [0, 3, 6, 9, 12, 15]
                        and check["exchange_rows"] == [res["rank"], 100 + res["rank"]]):
                    raise AssertionError(f"rank {res['rank']}: a collective wrapper gave a wrong result: {check}")
            elif not check["equal_single"]:
                raise AssertionError(f"rank {res['rank']}: {name} differs from the single-device result")
            if name.startswith("commit_columns_mesh") and not (check["launches"]["K4"] == 1 and check["ok_predicate"]):
                raise AssertionError(f"rank {res['rank']}: the sharded commit did not launch K4 once: {check}")
            if name.startswith("prove_rounds_mesh") and not (check["sharded"] and check["mesh_rounds"] > 0):
                raise AssertionError(f"rank {res['rank']}: the batch-eval rounds did not run sharded: {check}")
            if name.startswith("forest") and (check["plan"]["discarded_levels"], check["plan"]["groups"]) != (3, 3):
                raise AssertionError(f"rank {res['rank']}: the forced plan was not taken: {check['plan']}")
    if len({json.dumps({n: c.get("sha256") for n, c in r["results"].items()}, sort_keys=True) for r in pieces}) != 1:
        raise AssertionError("the two ranks' results differ")
    log(f"phase 14 the group's pieces, 2 ranks on cuda:0 over gloo ({time.perf_counter() - t0:.1f} s with the "
        f"ranks' start): every piece == its single-device result on both ranks; seconds on rank 0 (two ranks "
        f"time-share the card): "
        + "; ".join(f"{n} {c.get('seconds', c['check_s']):.3f}" for n, c in pieces[0]["results"].items())
        + f"; collectives of the wrappers check {pieces[0]['results']['wrappers']['collectives']}")

    # The "nccl" branch of the wrappers: a group of one rank on the card
    # (two ranks cannot share a GPU under NCCL), every wrapper once on CUDA
    # tensors handed to the collectives as they are.
    nccl = launch(1, "checks", {"checks": [{"name": "wrappers", "kind": "wrappers", "seed": 14}]},
                  work_dir=jobs_dir, device="cuda:0", backend="nccl", timeout_s=300, command=rank_command)
    check = nccl[0]["results"]["wrappers"]
    if not (check["rows_to_columns_ok"] and check["gather_cyclic_ok"] and check["gather_last_ok"]
            and check["all_reduce"] == [0, 1, 2, 3, 4, 5] and check["exchange_rows"] == [0]
            and check["collectives"] == {"all_reduce": 1, "all_gather": 3, "all_to_all": 2}):
        raise AssertionError(f"the wrappers under a one-rank nccl group gave a wrong result: {check}")
    log(f"phase 14 nccl: one rank on cuda:0, every wrapper once on CUDA tensors, collectives {check['collectives']}")

    group_launches = {}
    for name, version, timeout_s in (("v1-nop-2^22", 1, 600), ("v2-nop-2^20", 2, 900)):
        case = pinned[name]
        t0 = time.perf_counter()
        ranks = on_two_ranks("prove", {"program": case["program"], "max_steps": case["max_steps"],
                                       "protocol_version": version}, timeout_s=timeout_s)
        for res in ranks:
            got = (res["num_steps"], res["bytes"], res["sha256"], res["verify"])
            want = (case["num_steps"], case["bytes"], case["sha256"], "Accept")
            if got != want:
                raise AssertionError(f"{name} on rank {res['rank']}: {got} differs from the pinned {want}")
            counts, t = res["launches"], res["timings"]
            if version == 1 and not (counts["K1"] > 0 and counts["K2"] > 0):
                raise AssertionError(f"{name} on rank {res['rank']}: K1 or K2 was not launched: {counts}")
            if version == 2:
                if not (counts["K1"] > 0 and counts["K2"] > 0 and counts["K4"] > 0 and counts["N1"] > 0
                        and counts["N2"] > 0):
                    raise AssertionError(f"{name} on rank {res['rank']}: K1, K2, K4, N1 or N2 was not launched: "
                                         f"{counts}")
                # every block of the rank's rows is 2^16 -> 2^19: N2 once a block, one pass
                n2_want = counts["N1"] * len(ntt_dev.n2_passes(1 << 16, 1 << 19))
                if counts["N2"] != n2_want or counts["N2"] != N2_LAUNCHES[f"rank of the sharded {name}"]:
                    raise AssertionError(f"{name} on rank {res['rank']}: N2 launched {counts['N2']} times, not "
                                         f"{n2_want} (N1's {counts['N1']} blocks x their passes) and "
                                         f"{N2_LAUNCHES[f'rank of the sharded {name}']}")
                flags = {k: t.get(k) for k in ("data_commit_sharded", "advice_commit_sharded", "batch_eval_sharded",
                                               "open_sharded", "zerochecks_sharded")}
                if flags != {"data_commit_sharded": True, "advice_commit_sharded": True, "batch_eval_sharded": True,
                             "open_sharded": True, "zerochecks_sharded": False}:
                    raise AssertionError(f"{name} on rank {res['rank']}: what ran sharded: {flags}")
                shapes = [list(t["data_commit_shape"]), list(t["advice_commit_shape"])]
                if shapes != [[V2_DATA_ROWS, 1 << 16, 1 << 19], [V2_ADVICE_ROWS, 1 << 16, 1 << 19]]:
                    raise AssertionError(f"{name} on rank {res['rank']}: the commits' (rows, n, n_e) {shapes} are "
                                         f"not the shapes whose column shards phase 2 held K4 to")
                if (t["data_commit_path"], t["advice_commit_path"]) != ("mesh", "mesh"):
                    raise AssertionError(f"{name} on rank {res['rank']}: commit paths "
                                         f"{t['data_commit_path']}, {t['advice_commit_path']}")
            keys = [k for k in ("total_s", "execute_s", "witness_dev_s", "forest_s", "evals_s", "opens_s", "unified_s",
                                "data_commit_s", "advice_commit_s", "zerochecks_s", "batch_eval_s", "open_s",
                                "lasso_s", "forest_plan") if k in t]
            log(f"phase 15 {name} on rank {res['rank']} of 2 sharing cuda:0: sha256 {res['sha256'][:16]} == pinned, "
                f"{res['bytes']} B, Accept, launches {counts}, max_memory_allocated {res['max_memory_allocated']} B, "
                f"max_memory_reserved {res['max_memory_reserved']} B, " + " ".join(f"{k}={t[k]}" for k in keys))
        group_launches[name] = [res["launches"] for res in ranks]
        log(f"phase 15 {name}: both ranks' proofs == the pinned digest ({time.perf_counter() - t0:.1f} s with the "
            f"ranks' start)")

    # A lost rank: rank 1 kills itself after initialize.  The launcher must
    # fail within its timeout and leave no result; the relaunch must give
    # the pinned digest.
    case = pinned["v1-nop-2^16"]
    spec = {"program": case["program"], "max_steps": case["max_steps"], "protocol_version": 1}
    t0 = time.perf_counter()
    try:
        on_two_ranks("prove_lost_rank", dict(spec, lost_rank=1), timeout_s=120)
    except LaunchFailed as failure:
        failed_s = time.perf_counter() - t0
        reason = str(failure).splitlines()[0]
    else:
        raise AssertionError("a job whose rank 1 killed itself did not fail")
    left = [f for f in os.listdir(jobs_dir) if f.startswith("result_")]
    if left or failed_s >= 120:
        raise AssertionError(f"the failed job took {failed_s:.1f} s and left {left}")
    ranks = on_two_ranks("prove", spec, timeout_s=300)
    if {(r["sha256"], r["verify"]) for r in ranks} != {(case["sha256"], "Accept")}:
        raise AssertionError("the relaunched job's proofs differ from the pinned digest")
    log(f"phase 15 lost rank: the job failed in {failed_s:.1f} s ({reason}), no result file left; the relaunch "
        f"gave sha256 {case['sha256'][:16]} == pinned on both ranks")
    shutil.rmtree(jobs_dir, ignore_errors=True)
    return group_launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; an NVIDIA GPU is required",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import zigz_tpu_torch as zt
    from zigz_tpu_torch.device import card_info
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zigz_tpu_torch.commitments import device_forest, host_forest, ligero
    from zigz_tpu_torch.commitments.ligero import ligero_commit
    from zigz_tpu_torch.core import poseidon2 as p2_host
    from zigz_tpu_torch.core.hash import FiatShamirTranscript
    from zigz_tpu_torch.lookups import lasso, pipeline_lasso
    from zigz_tpu_torch.lookups.table_builder import build_xor_table
    from zigz_tpu_torch.ops import (_build, advice_dev, babybear, dag_dev, ext4_dev, keccak, ligero_dev, ntt_dev,
                                    poseidon2, witness_dev, zerocheck_dev_ext, zerocheck_gen)
    from zigz_tpu_torch.ops.zerocheck_native import NativeZerocheckProver
    from zigz_tpu_torch.prover import prover as prover_module
    from zigz_tpu_torch.prover import unified
    from zigz_tpu_torch.proofs.zerocheck import count_zerocheck_proofs, make_zerocheck_prover
    from zigz_tpu_torch import runtime
    from zigz_tpu_torch.runtime import native_vm

    F = zt.BabyBear
    dev = torch.device("cuda", 0)
    ser = zt.serialization.BinarySerializer(F)
    with open(os.path.join(ROOT, "zigz_tpu_torch", "testdata", "proof_digests.json")) as f:
        pinned = json.load(f)["proofs"]

    # -- phase 0: the card -------------------------------------------------
    info = card_info()
    if not info["nvidia_smi"]:
        raise RuntimeError(info["nvidia_smi_error"])
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sm_mhz, max_sm_mhz = (float(x) for x in clocks.split(","))
    log(f"phase 0 card: {info['nvidia_smi']} | SM clock {sm_mhz} MHz now, {max_sm_mhz} MHz max "
        f"| torch {info['torch']} cuda {info['cuda']} | devices {info['device_count']} | nvcc {info['nvcc']}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:  # each loader waits on its own g++; nvcc runs beside them
        host_libs = [pool.submit(fn) for fn in (runtime._load_dag, runtime._load_ext4, runtime._load_ntt,
                                                runtime._load_lasso, native_vm._load)]
        p2_unrolled = pool.submit(poseidon2_unrolled_count, info["nvcc"])
        chains = pool.submit(bound_chain_counts, info["nvcc"])
        kernels = _build.load()
        if not runtime.NATIVE_AVAILABLE or any(lib.result() is None for lib in host_libs):
            raise RuntimeError("the host C++ runtime (zigz_tpu_torch/runtime/*.cpp) did not build")
    log(f"phase 1 build: {time.perf_counter() - t0:.3f} s (nvcc {kernels.build_s:.3f} s; 6 host libraries) -> "
        f"{os.path.relpath(kernels.path, ROOT)}")
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # Z1 is generated for each DAG program: the programs of the v2-v4 proves
    # (the same ones), captured from a 16-step prove on the CPU, one nvcc
    # each, all started now; they build while the v1 phases run, and their
    # report is printed before phase 6.
    z1_t0 = time.perf_counter()
    z1_builds = {}
    for spec in capture_zerocheck_specs(2):
        for program in spec["programs"]:
            build = dag_dev.prepare(program)
            z1_builds.setdefault(build.key, (build, program))
    log(f"phase 1 Z1: {len(z1_builds)} distinct programs captured in {time.perf_counter() - z1_t0:.1f} s, "
        f"their nvcc processes started together")

    # Integer instructions of one Keccak-f[1600], from the SASS of K2 (a
    # straight-line kernel: one full-state permutation per thread).
    cuobjdump = os.path.join(os.path.dirname(info["nvcc"]), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", kernels.path], capture_output=True, text=True, check=True).stdout
    def function_opcodes(name):
        part = next(part for part in sass.split("Function :")[1:] if name in part.splitlines()[0])
        return re.findall(SASS_OPCODE, part, flags=re.M)

    opcodes = function_opcodes("sha3_merge")
    perm_instr = sum(1 for op in opcodes if op in ("LOP3", "SHF", "IADD3", "IMAD", "LEA", "PRMT", "MOV"))
    if not 1000 < perm_instr < 20000:
        raise AssertionError(f"implausible instruction count {perm_instr} for Keccak-f in K2's SASS ({len(opcodes)} in all)")
    log(f"phase 1 sass: K2 has {len(opcodes)} instructions, {perm_instr} of them integer ALU "
        f"({ {op: opcodes.count(op) for op in sorted(set(opcodes))} })")

    # Every kernel's whole body counted at every address under the
    # issue-slot and two-pipe model of the Poseidon2 kernels: K1's and K2's
    # (one permutation and its framing a thread, straight line), the
    # multiply chain's (one element a thread), and E1's two instantiations
    # (one output a thread).  K4 and K5 loop over rate blocks, so their whole
    # SASS is logged only: their bound takes a block's count and a column's
    # from chains of blocks (bound_chain_counts).
    keccak_counts = {key: issue_count(sass, f"sha3_{key}_kernel") for key in ("leaves", "merge", "columns", "absorb")}
    chain_count = issue_count(sass, "field_mul_chain_kernel")
    e1_counts = {name: issue_count(sass, "mle_fold_u64_kernel", name) for name in ("Goldilocks", "Mersenne61")}
    for name, count in (*keccak_counts.items(), ("field_mul_chain", chain_count), *e1_counts.items()):
        low, high = (3000, 12000) if name in keccak_counts else (10, 400)
        if not low < count["issued"] < high:
            raise AssertionError(f"implausible count {count['issued']} for {name} in its SASS")
        log(f"phase 1 sass: {name} issues {count['issued']} instructions a thread, {count['ALU']} on the ALU pipe "
            f"and {count['FMA']} IMAD on the FMA pipe ({count['opcodes']}): {count['sm_clocks']} SM clocks a "
            f"thread, set by {count['limb']}")

    # The multiply chain's integer instructions over its CHAIN + 1 multiplies:
    # Z1's bound counts a DAG's multiply at that (phase 9b).
    chain_opcodes = function_opcodes("field_mul_chain")
    chain_instr = sum(1 for op in chain_opcodes if op in INT_OPCODES)
    if not 50 < chain_instr < 400:
        raise AssertionError(f"implausible instruction count {chain_instr} in the multiply chain's SASS "
                             f"({len(chain_opcodes)} in all)")
    log(f"phase 1 sass: field_mul_chain has {len(chain_opcodes)} instructions, {chain_instr} of them integer ALU "
        f"({ {op: chain_opcodes.count(op) for op in sorted(set(chain_opcodes))} })")

    # Poseidon2's: one whole permutation, from P1 built once more with P0's
    # round loops unrolled (its nvcc ran beside the build above).
    p2_count = p2_unrolled.result()
    clock_ms = 1e3 / (SM_COUNT * max_sm_mhz * 1e6)
    first_ms = 1e3 / (INT32_LANES * max_sm_mhz * 1e6)
    log(f"phase 1 sass: P1 with P0's round loops unrolled (nvcc {p2_count['nvcc_s']:.1f} s) issues "
        f"{p2_count['issued']} instructions a permutation, {p2_count['ALU']} on the ALU pipe and {p2_count['FMA']} "
        f"IMAD on the FMA pipe ({p2_count['opcodes']}): {p2_count['sm_clocks']} SM clocks a permutation, set by "
        f"{p2_count['limb']}; bounds {(43 << 20) * p2_count['sm_clocks'] * clock_ms} ms (P1, P2) and "
        f"{68 * (1 << 19) * p2_count['sm_clocks'] * clock_ms} ms (P3); for comparison only, the first version's "
        f"yardstick ({P2_FIRST_VERSION_INSTR} integer instructions over the INT32 lanes): "
        f"{(43 << 20) * P2_FIRST_VERSION_INSTR * first_ms} ms (P1, P2) and {68 * (1 << 19) * P2_FIRST_VERSION_INSTR * first_ms} ms (P3)")
    p2_ptxas = kernel_ptxas(kernels.log, ("p2_leaves_kernel", "p2_merge_kernel", "p2_absorb_kernel"))
    unit_counts = chains.result()
    butterfly = unit_counts["butterfly"]
    log(f"phase 1 sass: one butterfly of N1/N2 (chains of 64 and 32 butterflies, nvcc {unit_counts['nvcc_s']:.1f} s) "
        f"issues {butterfly['issued']} instructions, {butterfly['ALU']} on the ALU pipe and {butterfly['FMA']} IMAD "
        f"on the FMA pipe ({butterfly['opcodes_64']} in the chain of 64): {butterfly['sm_clocks']} SM clocks a "
        f"butterfly, set by {butterfly['limb']}")
    for key in ("K4", "K5"):
        block, column = unit_counts[f"block_{key}"], unit_counts[f"column_{key}"]
        log(f"phase 1 sass: one rate block of {key}'s sponge (chains of 3 and 2 blocks) issues {block['issued']} "
            f"instructions, {block['ALU']} on the ALU pipe and {block['FMA']} IMAD on the FMA pipe "
            f"({block['opcodes_3']} in the chain of 3): {block['sm_clocks']} SM clocks a block, set by "
            f"{block['limb']}; a column's own code {column['issued']} instructions, {column['sm_clocks']} SM clocks")
    for name, report in p2_ptxas.items():
        log(f"phase 1 ptxas {name}: {report['registers']} registers, stack frame {report['stack_frame_B']} B, "
            f"spill stores {report['spill_stores_B']} B, spill loads {report['spill_loads_B']} B")

    def bound(units: int, nbytes: int, instr_each: int = perm_instr) -> dict:
        """The superseded bound, logged beside sass_bound's: bytes over the
        memory rate, or units (permutations by default) x their integer
        instructions over the INT32 instruction rate at the maximum clock."""
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = units * instr_each / (INT32_LANES * max_sm_mhz * 1e6) * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)

    # -- phase 2: kernels against their plain versions ---------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def byte_err(a, b) -> int:
        return int((a.view(torch.uint8).to(torch.int16) - b.view(torch.uint8).to(torch.int16)).abs().max())

    def event_ms(fn, x, reps) -> float:
        fn(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def edge_values(n):
        vals = torch.randint(0, P, (n,), device=dev, dtype=torch.int64, generator=gen)
        edge = torch.tensor([0, P - 1, -1], device=dev, dtype=torch.int64)[:n]  # -1 = 2^64 - 1
        vals[: edge.numel()] = edge
        return vals

    def check_hashlib(name, digests, messages, idx):
        """Digests at ``idx`` against hashlib of the messages: one u64 value
        (8 bytes, little-endian) or eight lanes (64 bytes) per row."""
        for got, msg in zip(digests[idx].cpu(), messages[idx].cpu()):
            data = msg.numpy().tobytes() if msg.dim() else (int(msg) % (1 << 64)).to_bytes(8, "little")
            if got.numpy().tobytes() != hashlib.sha3_256(data).digest():
                raise AssertionError(f"{name}: a digest differs from hashlib")

    results = {}
    leaves_in = edge_values(43 << 20)
    leaves_out = keccak.sha3_leaves(leaves_in)
    err = byte_err(leaves_out, keccak._sha3_leaves_plain(leaves_in))
    sample = torch.randint(0, leaves_in.numel(), (64,), generator=gen, device=dev)
    check_hashlib("K1", leaves_out, leaves_in, torch.cat([torch.arange(3, device=dev), sample]))
    merge_in = leaves_out.view(-1, 8)
    merge_out = keccak.sha3_merge(merge_in)
    merge_err = byte_err(merge_out, keccak._sha3_merge_plain(merge_in))
    check_hashlib("K2", merge_out, merge_in, sample // 2)
    for n in (1, 255, 4097):
        vals = edge_values(n)
        got = keccak.sha3_leaves(vals)
        err = max(err, byte_err(got, keccak._sha3_leaves_plain(vals)))
        check_hashlib(f"K1 n={n}", got, vals, torch.arange(n, device=dev))
        msg = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 8), device=dev, dtype=torch.int64, generator=gen)
        got = keccak.sha3_merge(msg)
        merge_err = max(merge_err, byte_err(got, keccak._sha3_merge_plain(msg)))
        check_hashlib(f"K2 n={n}", got, msg, torch.arange(n, device=dev))
    if err or merge_err:
        raise AssertionError(f"kernels disagree with their plain versions: K1 {err}, K2 {merge_err}")
    def sass_bound(key, units: int, nbytes: int, count: dict, superseded: dict) -> dict:
        """A kernel's bound: the bytes against the units (hashes,
        permutations or elements) x the SM clocks one thread of the kernel
        takes for one (``count``, its whole SASS); the superseded bound is
        logged beside it."""
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = units * count["sm_clocks"] * clock_ms
        log(f"phase 2 {key}: bound {max(bytes_ms, ops_ms)} ms from the whole SASS ({count['sm_clocks']} SM clocks "
            f"a unit, set by {count['limb']}); superseded: {superseded['bound_ms']} ms")
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)

    def sponge_bound(key, blocks: int, columns: int, nbytes: int) -> dict:
        """K4's or K5's bound (``key`` "columns" or "absorb"): the bytes
        against ``blocks`` rate blocks x one block's instructions plus
        ``columns`` x a column's own (bound_chain_counts), under the
        issue-slot and two-pipe model; the superseded bound (K2's first
        4,096 instructions over the INT32 lanes a permutation) and the whole
        SASS billed to every block are logged beside it."""
        k = {"columns": "K4", "absorb": "K5"}[key]
        block, column = unit_counts[f"block_{k}"], unit_counts[f"column_{k}"]
        work = with_clocks({c: blocks * block[c] + columns * column[c] for c in ("issued", *P2_PIPES)})
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = work["sm_clocks"] * clock_ms
        log(f"phase 2 {key}: bound {max(bytes_ms, ops_ms)} ms from {blocks} blocks x {block['sm_clocks']} SM clocks "
            f"+ {columns} columns x {column['sm_clocks']} (set by {work['limb']}), bytes {bytes_ms} ms; superseded: "
            f"{bound(blocks, nbytes)['bound_ms']} ms (K2's first 4,096 instructions), {blocks * keccak_counts[key]['sm_clocks'] * clock_ms} ms "
            f"(the whole SASS a block)")
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)

    def keccak_bound(key, units: int, nbytes: int) -> dict:
        """K1 or K2 (``key``): units are hashes, the superseded bound K2's
        first 4,096 instructions over the INT32 lanes."""
        return sass_bound(key, units, nbytes, keccak_counts[key], bound(units, nbytes))

    results["leaves"] = dict(max_abs_err=err, shape=f"({43 << 20},) -> ({43 << 20}, 4)",
                             ms=event_ms(keccak.sha3_leaves, leaves_in, 20),
                             plain_ms=event_ms(keccak._sha3_leaves_plain, leaves_in, 2),
                             **keccak_bound("leaves", 43 << 20, (43 << 20) * (8 + 32)))
    results["merge"] = dict(max_abs_err=merge_err, shape=f"({43 << 19}, 8) -> ({43 << 19}, 4)",
                            ms=event_ms(keccak.sha3_merge, merge_in, 20),
                            plain_ms=event_ms(keccak._sha3_merge_plain, merge_in, 2),
                            **keccak_bound("merge", 43 << 19, (43 << 19) * (64 + 32)))
    del leaves_in, leaves_out, merge_in, merge_out
    torch.cuda.empty_cache()

    def words(r, n):
        """(r, n) random canonical int32 message words; the first two are
        0 and p - 1."""
        w = torch.randint(0, P, (r, n), device=dev, dtype=torch.int32, generator=gen)
        edge = torch.tensor([0, P - 1], device=dev, dtype=torch.int32)[: min(2, w.numel())]
        w.view(-1)[: edge.numel()] = edge
        return w

    def check_columns(name, digests, mat, cols):
        """Digests of columns ``cols`` against hashlib of their words, little-endian."""
        for j in cols:
            col = mat[:, j].cpu().numpy().astype("<u4").tobytes()
            if digests[j].cpu().numpy().tobytes() != hashlib.sha3_256(col).digest():
                raise AssertionError(f"{name}: the digest of column {j} differs from hashlib")

    def stream_raw(mat):
        """K5 over the raw rows of ``mat``, in the streamed commit's blocks."""
        r, n = mat.shape
        state = torch.zeros((25, n), dtype=torch.int64, device=dev)
        for k0, live, nb in ligero_dev._stream_blocks(r):
            ligero_dev.sha3_absorb(state, mat[k0 : k0 + live], k0, nb, r)
        return state[:4].t().contiguous()

    n_e = 1 << 19
    state0 = torch.randint(-(1 << 63), (1 << 63) - 1, (25, n_e), device=dev, dtype=torch.int64, generator=gen)
    block = words(544, n_e)
    absorbed = ligero_dev.sha3_absorb(state0.clone(), block, 0, 16, V2_DATA_ROWS)
    absorb_err = byte_err(absorbed, ligero_dev._sha3_absorb_plain(state0.clone(), block, 0, 16, V2_DATA_ROWS))
    scratch = state0.clone()
    results["absorb"] = dict(
        max_abs_err=absorb_err, shape=f"state (25, {n_e}) + (544, {n_e}) words, 16 rate blocks",
        ms=event_ms(lambda s: ligero_dev.sha3_absorb(s, block, 0, 16, V2_DATA_ROWS), scratch, 20),
        plain_ms=event_ms(lambda s: ligero_dev._sha3_absorb_plain(s, block, 0, 16, V2_DATA_ROWS), scratch, 2),
        **sponge_bound("absorb", 16 * n_e, n_e, n_e * (2 * 25 * 8 + 544 * 4)))  # the state read and written, the block read
    del state0, absorbed, scratch, block

    # K4 at the shapes its callers give it: the (rows, n_e / 2) column shard
    # of each commit of the sharded 2^20 v2 prove on two ranks (phase 15),
    # and ligero_commit_device's 688 x 2^19 (phase 7).
    columns_err, columns_at = 0, {}
    for key, r, n in (("columns", V2_ADVICE_ROWS, n_e // 2), ("columns_data_shard", V2_DATA_ROWS, n_e // 2),
                      ("columns_commit_device", 688, n_e)):
        mat = words(r, n)
        columns_out = ligero_dev.sha3_columns(mat)
        err_here = byte_err(columns_out, ligero_dev._sha3_columns_plain(mat))
        check_columns(f"K4 ({r}, {n})", columns_out, mat, [0, 1, n - 1, *sample[:8].remainder(n).tolist()])
        columns_at[key] = dict(
            max_abs_err=err_here, shape=f"({r}, {n}) -> ({n}, 4)",
            ms=event_ms(ligero_dev.sha3_columns, mat, 10),
            plain_ms=event_ms(ligero_dev._sha3_columns_plain, mat, 2),
            **sponge_bound("columns", ligero_dev.pad_words(r) // ligero_dev.RATE_WORDS * n, n, n * (r * 4 + 32)))
        columns_err = max(columns_err, err_here)
        del mat, columns_out
        torch.cuda.empty_cache()
    results.update(columns_at)

    for n in (1, 255, 4097):
        for r in (1, 33, 34, 543, 544, 545):
            mat = words(r, n)
            plain = ligero_dev._sha3_columns_plain(mat)
            columns_err = max(columns_err, byte_err(ligero_dev.sha3_columns(mat), plain))
            absorb_err = max(absorb_err, byte_err(stream_raw(mat), plain))
            check_columns(f"K4/K5 ({r}, {n})", plain, mat, sorted({0, n - 1}))
    for key in columns_at:
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], columns_err)
    results["absorb"]["max_abs_err"] = absorb_err
    if columns_err or absorb_err:
        raise AssertionError(f"kernels disagree with their plain versions: K4 {columns_err}, K5 {absorb_err}")
    for name, r in results.items():
        log(f"phase 2 {name}: kernel == plain == hashlib (max byte err {r['max_abs_err']}); "
            f"{r['shape']}: kernel {r['ms']} ms, plain {r['plain_ms']} ms, "
            f"bound {r['bound_ms']} ms by {r['bound_by']}")
    # -- phase 2, Poseidon2: P1-P3 against their plain versions -------------
    results.update(poseidon2_kernel_phase(dev, max_sm_mhz, p2_count))

    # -- phase 2c: E1, the 64-bit fold, against its plain version ------------
    e1_results = field64_kernel_phase(dev, max_sm_mhz, e1_counts, kernels.log)

    # -- phase 2d: N1 and N2, the Reed-Solomon encode, against its plain version
    ntt_results = ntt_kernel_phase(dev, max_sm_mhz, butterfly, kernels.log)

    # -- phase 2e: W1, the witness rows, against its plain version -----------
    w1_results = witness_kernel_phase(dev, kernels.log)

    def canonical(shape):
        """Random canonical int32."""
        return torch.randint(0, P, shape, device=dev, dtype=torch.int32, generator=gen)

    def host_u64(t):
        return t.cpu().numpy().astype("uint64")

    def launches_of(fn, x) -> int:
        """CUDA kernels that one call of fn(x) launches (the profiler)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
        return sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)

    # The device functions that are torch ops: ms by CUDA events and
    # launches by the profiler, at the widths of the 2^20 proves.
    weights = host_u64(canonical((688,)))
    wide = words(688, 1 << 16)
    if not (ligero_dev.vecmat_device(weights, wide) == ligero._vecmat(weights, host_u64(wide))).all():
        raise AssertionError("vecmat_device differs from the host _vecmat")
    torch_ops = {}
    for name, fn, x, reps in (
            ("vecmat_device (688,) x (688, 65536)", lambda m: ligero_dev.vecmat_device(weights, m), wide, 5),):
        torch_ops[name] = dict(ms=event_ms(fn, x, reps), launches=launches_of(fn, x))
        log(f"phase 2 torch op {name}: {torch_ops[name]['ms']} ms, {torch_ops[name]['launches']} launches")
    del wide
    torch.cuda.empty_cache()

    # -- phase 2b: the bench's multiply-chain kernel, then the bench --------
    import bench_torch

    def chain_inputs(n):
        """(x, y): (n,) random canonical int32, 0, 1 and p - 1 first in x and
        in y, in both orders."""
        x, y = canonical((n,)), canonical((n,))
        edge = torch.tensor([0, 1, P - 1], device=dev, dtype=torch.int32)
        x[: min(n, 3)] = edge[: min(n, 3)]
        y[: min(n, 3)] = edge.flip(0)[: min(n, 3)]
        return x, y

    chain_err = 0
    for n in (1, 255, 4097, 1 << 22):
        x, y = chain_inputs(n)
        chain_err = max(chain_err, byte_err(babybear.mul_chain(x, y), babybear._mul_chain_plain(x, y)))
    if chain_err:
        raise AssertionError(f"the multiply-chain kernel disagrees with its plain version: byte err {chain_err}")
    results["mul_chain"] = dict(max_abs_err=chain_err, shape=f"({1 << 22},) x2 int32 -> ({1 << 22},)",
                                ms=bench_torch.queued_event_ms(babybear.mul_chain, x, y, 20),
                                plain_ms=bench_torch.queued_event_ms(babybear._mul_chain_plain, x, y, 20),
                                **sass_bound("mul_chain", 1 << 22, (1 << 22) * 12, chain_count,
                                             bound(1 << 22, (1 << 22) * 12, instr_each=chain_instr)))
    r = results["mul_chain"]
    log(f"phase 2b mul_chain: kernel == plain at 1, 255, 4097 and 2^22 elements (max byte err {chain_err}); "
        f"{r['shape']}: kernel {r['ms']} ms, plain {r['plain_ms']} ms, bound {r['bound_ms']} ms by {r['bound_by']}")
    del x, y
    # This slice's path: the bench itself, at the two ladder sizes pinned for it.
    bench_out = io.StringIO()
    babybear.LAUNCHES["mul_chain"] = 0
    with contextlib.redirect_stdout(bench_out):
        bench_torch.main(["--v1", "14", "18", "--v2", "--v3", "--v4"])
    chain_launches = babybear.LAUNCHES["mul_chain"]
    bench_lines = bench_out.getvalue().strip().splitlines()
    bench_line = json.loads(bench_lines[-1])
    b = bench_line["extra"]
    if not (bench_line["metric"] == "babybear_field_ops_per_s_per_chip" and bench_line["value"] > 0
            and bench_line["unit"] == "field_mul/s" and b["backend"] == "cuda"
            and bench_lines[-2] == info["nvidia_smi"] == b["cuda_device"]["nvidia_smi"]
            and [(e["num_steps"], e["sha256"], e["held"]) for e in b["v1_ladder"]]
            == [(pinned[n]["num_steps"], pinned[n]["sha256"], "pinned") for n in ("v1-nop-2^14", "v1-nop-2^18")]
            and b["field_kernel_launches"] == chain_launches == 2 + bench_torch.FIELD_REPS):
        raise AssertionError(f"the bench's line is not what its run should give ({chain_launches} launches): "
                             f"{bench_line}")
    log(f"phase 2b bench_torch.py --v1 14 18: {bench_line['value']} field_mul/s (kernel {b['field_kernel_ms']} ms a "
        f"rep of 2^22 lanes, plain int64 chain {b['torch_int64_mul_per_s']} mul/s), v1 2^14 and 2^18 == pinned, "
        f"host_anchor_s {b['host_anchor_s']}, mul_chain launches {chain_launches}")

    # -- proves ------------------------------------------------------------
    def check_w1(prover, counts, version=1):
        """W1 once a prove of a native trace that commits the 43 rows (v1,
        v2, v3; v4 commits no witness trees), over all its real steps; never
        for the Python VM's trace."""
        want = (1, prover.last_timings["num_steps"]) if prover.use_native_vm and version != 4 else (0, 0)
        if (counts["W1"], counts["W1_steps"]) != want:
            raise AssertionError(f"v{version}: W1 launched {counts['W1']} times over {counts['W1_steps']} steps, "
                                 f"not {want[0]} over {want[1]}")

    def port_prove(program, entry, segments, tape, max_steps, field=F):
        keccak.LAUNCHES.update(leaves=0, merge=0)
        witness_dev.ROWS.update(launches=0, steps=0)
        prover = zt.Prover(field, seed=0, device=dev)
        proof = prover.prove(program, entry, None, max_steps, segments, tape)
        counts = {**keccak.LAUNCHES, "W1": witness_dev.ROWS["launches"], "W1_steps": witness_dev.ROWS["steps"]}
        if proof.metadata.num_steps > 1 and not (counts["leaves"] > 0 and counts["merge"] > 0):
            raise AssertionError(f"the prove did not launch both kernels: {counts}")
        check_w1(prover, counts)
        if proof.metadata.num_steps >= 1 << 20 and not prover.use_native_vm:
            raise AssertionError("the native VM is required at 2^20 steps and above")
        field_ser = zt.serialization.BinarySerializer(field)
        data = field_ser.serialize(proof)
        verdict = zt.Verifier(field).verify(field_ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's proof was rejected: {verdict}")
        return data, prover, counts

    def load_case(name):
        """(program, entry, segments, tape, max_steps, entry of the file) of a pinned case."""
        case = pinned[name]
        spec = case["program"]
        if spec["kind"] == "nop":
            return NOP * spec["count"], 0x1000, None, None, case["max_steps"], case
        with open(os.path.join(ROOT, "tests", "fixtures", spec["name"]), "rb") as f:
            program = f.read()
        loaded = zt.elf.load(program)
        return program, loaded.entry_pc, loaded.segments, spec.get("tape"), case["max_steps"], case

    def check_pinned(name, case, data, num_steps):
        got = (num_steps, len(data), sha(data))
        want = (case["num_steps"], case["bytes"], case["sha256"])
        if got != want:
            raise AssertionError(f"{name}: (steps, bytes, sha256) {got} differ from the pinned {want}")

    def timings(prover) -> str:
        t = prover.last_timings
        keys = ("total_s", "execute_s", "witness_dev_s", "forest_s", "evals_s", "opens_s",
                "sumcheck_lasso_s", "commitments_s", "forest_plan")
        return " ".join(f"{k}={t[k]}" for k in keys) + f" steps_per_s={t['num_steps'] / t['total_s']}"

    # -- phase 3: golden fixtures -----------------------------------------
    fixtures = os.path.join(ROOT, "tests", "fixtures")
    for name, tape in (("nop4", None), ("add", None), ("fibonacci", [10])):
        with open(os.path.join(fixtures, f"{name}_program.bin"), "rb") as f:
            program = f.read()
        with open(os.path.join(fixtures, f"{name}_v1.bin"), "rb") as f:
            golden = f.read()
        entry, segments = 0x1000, None
        if zt.elf.is_elf(program):
            loaded = zt.elf.load(program)
            entry, segments = loaded.entry_pc, loaded.segments
        data, prover, counts = port_prove(program, entry, segments, tape, 1 << 16)
        if data != golden:
            raise AssertionError(f"{name}: port proof bytes differ from {name}_v1.bin")
        log(f"phase 3 {name}: bytes == {name}_v1.bin ({len(data)} B), Accept, launches {counts}")

    # -- phase 4: against the pinned digests --------------------------------
    for name in ("v1-nop-2^16", "v1-nop-2^20", "v1-fibonacci-150000"):
        program, entry, segments, tape, max_steps, case = load_case(name)
        data, prover, counts = port_prove(program, entry, segments, tape, max_steps)
        check_pinned(name, case, data, prover.last_timings["num_steps"])
        log(f"phase 4 {name}: steps {prover.last_timings['num_steps']} sha256 {sha(data)[:16]} == pinned, "
            f"{len(data)} B, Accept, launches {counts}")
        log(f"  port timings: {timings(prover)}")

    # -- phase 4b: v1 over the other fields below 2^31 ----------------------
    for name in ("v1-koalabear-nop-2^16", "v1-mersenne31-nop-2^16"):
        program, entry, segments, tape, max_steps, case = load_case(name)
        field = getattr(zt.core.field, case["field"])
        data, prover, counts = port_prove(program, entry, segments, tape, max_steps, field=field)
        check_pinned(name, case, data, prover.last_timings["num_steps"])
        log(f"phase 4b {name}: p = {field.MODULUS}, steps {prover.last_timings['num_steps']} sha256 "
            f"{sha(data)[:16]} == pinned, {len(data)} B, Accept, launches {counts}")

    # -- phase 5: the v1 main path at 2^22 steps ---------------------------
    program, entry, segments, tape, max_steps, case = load_case("v1-nop-2^22")
    torch.cuda.reset_peak_memory_stats(dev)
    data, prover, main_counts = port_prove(program, entry, segments, tape, max_steps)
    check_pinned("v1-nop-2^22", case, data, prover.last_timings["num_steps"])
    if prover.last_timings["forest_plan"]["discarded_levels"] or prover.last_timings["forest_plan"]["groups"] != 1:
        raise AssertionError(f"the shipped plan frees or groups at 2^22 steps: {prover.last_timings['forest_plan']}")
    log(f"phase 5 v1-nop-2^22: sha256 {sha(data)[:16]} == pinned, {len(data)} B, Accept, launches {main_counts}, "
        f"peak device memory {torch.cuda.max_memory_allocated(dev)} B allocated, "
        f"{torch.cuda.max_memory_reserved(dev)} B reserved")
    log(f"  port timings: {timings(prover)}")
    del data, program
    torch.cuda.empty_cache()

    # -- phases 4c and 5b: v1 over Goldilocks and Mersenne61 -----------------
    wide_launches = wide_field_phases(dev, pinned)

    # -- phase 1, Z1's generated kernels: wait for them -----------------------
    t0 = time.perf_counter()
    for build, program in sorted(z1_builds.values(), key=lambda b: len(b[1].code)):
        log(f"phase 1 Z1 generated, {len(program.code)} instructions, {len(program.outs)} outputs: "
            f"{build_report(build)}")
    log(f"phase 1 Z1: {len(z1_builds)} programs built {time.perf_counter() - z1_t0:.1f} s after their start "
        f"(waited {time.perf_counter() - t0:.1f} s here)")

    # -- phases 6, 8, 9: the v2, v4 and v3 main paths -----------------------
    # Every advice commit is watched: the spy keeps the device twins' planes
    # and the host advice columns by reference, and after the prove has
    # returned each plane is held against its host column, on the card.
    # Nothing is copied, compared or synchronized inside the timed prove;
    # the twins are timed by CUDA events that are read afterwards.
    advice_seen = {}
    commit_mixed = unified.ligero_commit_mixed

    def watched_commit(F_, columns, hash_mode="sha3", *, device, dev_columns=None, group=None):
        if dev_columns:
            advice_seen["planes"] = dict(dev_columns)
            advice_seen["host"] = columns
        return commit_mixed(F_, columns, hash_mode, device=device, dev_columns=dev_columns, group=group)

    unified.ligero_commit_mixed = watched_commit
    twin_events = {}

    def timed_twin(twin_name):
        twin = getattr(advice_dev, twin_name)

        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = twin(*args, **kwargs)
            end.record()
            twin_events[twin_name] = (start, end)
            return out

        setattr(advice_dev, twin_name, run)

    for twin_name in ("core_logup_advice_dev", "regcheck_advice_dev", "bytecode_advice_dev"):
        timed_twin(twin_name)

    # Every extension zerocheck of a prove is recorded (its width, host tail
    # and combiner, no column data): its launches of Z1 and Z2 follow from
    # its width, and phase 9b runs the kernels on the 2^20 v2 prove's DAGs.
    zc_seen = []
    zc_prove = zerocheck_dev_ext.GenericDeviceZerocheckExt.prove

    def watched_zc_prove(self, transcript):
        zc_seen.append(zerocheck_spec(self))
        return zc_prove(self, transcript)

    zerocheck_dev_ext.GenericDeviceZerocheckExt.prove = watched_zc_prove

    def check_advice_planes():
        """(planes, their bytes, ms per twin) of the last prove; raises where a
        plane differs from the host advice column of the same prove."""
        planes, host = advice_seen.pop("planes", {}), advice_seen.pop("host", {})
        for col_name, plane in planes.items():
            host_col = torch.from_numpy(host[col_name].astype("int64")).to(plane.device)
            if not torch.equal(plane.to(torch.int64), host_col):
                raise AssertionError(f"device advice plane {col_name} differs from the host advice column")
        if sorted({c.split(":")[0] for c in planes}) != ["bc", "rc", "v2"]:
            raise AssertionError(f"not every argument built its planes on the device: {sorted(planes)}")
        torch.cuda.synchronize()
        twin_ms = {name: start.elapsed_time(end) for name, (start, end) in twin_events.items()}
        return len(planes), sum(pl.numel() * pl.element_size() for pl in planes.values()), twin_ms

    def port_prove_v2(program, entry, segments, tape, max_steps, version=2):
        keccak.LAUNCHES.update(leaves=0, merge=0)
        ligero_dev.LAUNCHES.update(columns=0, absorb=0)
        ntt_dev.LAUNCHES.update(dict.fromkeys(ntt_dev.LAUNCHES, 0))
        poseidon2.LAUNCHES.update(leaves=0, merge=0, absorb=0)
        poseidon2.PERMUTATIONS["count"] = 0
        ligero.STITCHED.update(dev_columns=0, host_rows=0)
        zerocheck_dev_ext.reset_counters()
        dag_dev.LAUNCHES["round_sums"] = 0
        ext4_dev.LAUNCHES["fold_planes"] = 0
        witness_dev.ROWS.update(launches=0, steps=0)
        zc_seen.clear()
        pipeline_lasso.DEVICE_ROUNDS["count"] = 0
        advice_seen.clear()
        twin_events.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        prover = zt.Prover(F, seed=0, protocol_version=version)  # the default device: the card
        if prover.device.type != "cuda":
            raise AssertionError(f"Prover's default device is {prover.device}, not the card")
        proof = prover.prove(program, entry, None, max_steps, segments, tape)
        peak = torch.cuda.max_memory_allocated(dev)  # before the checks below allocate
        counts = {**keccak.LAUNCHES, **ligero_dev.LAUNCHES, "N1": ntt_dev.LAUNCHES["tile"],
                  "N2": ntt_dev.LAUNCHES["pass"], "P1": poseidon2.LAUNCHES["leaves"],
                  "P2": poseidon2.LAUNCHES["merge"], "P3": poseidon2.LAUNCHES["absorb"],
                  "p2_permutations": poseidon2.PERMUTATIONS["count"], **dag_dev.LAUNCHES, **ext4_dev.LAUNCHES,
                  "W1": witness_dev.ROWS["launches"], "W1_steps": witness_dev.ROWS["steps"]}
        check_w1(prover, counts, version)
        if counts["columns"]:
            raise AssertionError(f"K4 is on no prove, yet the v{version} prove launched it: {counts}")
        # v2: SHA3 forest and sponge (K1, K2, K5); v4: no forest (K5); v3:
        # Poseidon2 throughout (P1, P2, P3).  No prove on the card runs the
        # plain Poseidon2 permutation.
        want = {2: (True, True, True, False, False, False), 3: (False, False, False, True, True, True),
                4: (False, False, True, False, False, False)}[version]
        if (tuple(bool(counts[k]) for k in ("leaves", "merge", "absorb", "P1", "P2", "P3")) != want
                or counts["p2_permutations"]):
            raise AssertionError(f"the v{version} prove's launches are not those of its path: {counts}")
        # N1 once a 544-row block of each commit, at commit time and again in
        # the openings (which re-encode every block), and N2 once a pass of
        # each: no encode of the prove ran the plain version.
        shapes = [prover.last_timings[f"{c}_commit_shape"] for c in ("data", "advice")]
        blocks = sum(-(-rows // 544) for rows, _, _ in shapes)
        n2_want = sum(2 * -(-rows // 544) * len(ntt_dev.n2_passes(n, n_e)) for rows, n, n_e in shapes)
        if (counts["N1"], counts["N2"]) != (2 * blocks, n2_want):
            raise AssertionError(f"v{version}: N1/N2 launched {counts['N1']}/{counts['N2']} times, not "
                                 f"{2 * blocks}/{n2_want} for the commits' {blocks} stream blocks, encoded twice")
        if version == 3:
            # P3 once a 544-row stream block of each commit
            if counts["P3"] != blocks:
                raise AssertionError(f"v3: {counts['P3']} launches of P3, not one for each of the commits' "
                                     f"{blocks} stream blocks")
        device_work = {"zerochecks": count_zerocheck_proofs(proof),
                       "device_zerochecks": zerocheck_dev_ext.DEVICE_PROVES["count"],
                       "sweep_launches": zerocheck_dev_ext.DEVICE_PROVES["sweep_launches"],
                       "columns_resident": zerocheck_dev_ext.COLUMNS["resident"],
                       "columns_uploaded": zerocheck_dev_ext.COLUMNS["uploaded"],
                       "lasso_device_rounds": pipeline_lasso.DEVICE_ROUNDS["count"],
                       "advice_planes_on_device": ligero.STITCHED["dev_columns"],
                       "advice_rows_uploaded": ligero.STITCHED["host_rows"]}
        if device_work["device_zerochecks"] != device_work["zerochecks"] or not device_work["zerochecks"]:
            raise AssertionError(f"not every zerocheck ran on the device: {device_work}")
        # The sweep is Z1 and Z2 and nothing else: their launches are those
        # the zerochecks' widths and host tail imply.
        device_work["sweep_launches_implied"] = sum(card_zerocheck_launches(z["n"], z["host_tail"]) for z in zc_seen)
        if not (device_work["sweep_launches"] == counts["round_sums"] + counts["fold_planes"]
                == device_work["sweep_launches_implied"] and counts["round_sums"] and counts["fold_planes"]):
            raise AssertionError(f"the zerocheck sweep did not run through Z1 and Z2 alone: {device_work}, {counts}")
        if not device_work["lasso_device_rounds"] or not device_work["columns_resident"]:
            raise AssertionError(f"the Lasso rounds or the resident columns were not used: {device_work}")
        planes_checked, planes_held_B, twin_ms = check_advice_planes()
        if not (device_work["advice_planes_on_device"] == planes_checked
                == prover.last_timings["advice_dev_cols"] == 148):
            raise AssertionError(f"the advice planes were not all built on the device: {device_work}, "
                                 f"{planes_checked} checked")
        device_work.update(advice_twins_ms=twin_ms, planes_held_for_the_check_B=planes_held_B)
        paths = (prover.last_timings["data_commit_path"], prover.last_timings["advice_commit_path"])
        if paths != ("stream-dev", "stream-dev"):
            raise AssertionError(f"the v{version} commits did not take the device path: {paths}")
        if bool(proof.witness_commitments) != (version != 4):
            raise AssertionError(f"v{version}: {len(proof.witness_commitments)} witness commitments")
        data = ser.serialize(proof)
        verdict = zt.Verifier(F).verify(ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's v{version} proof was rejected: {verdict}")
        return data, prover, counts, peak, device_work

    v2_keys = ("total_s", "execute_s", "data_commit_s", "data_assemble_s", "data_upload_s",
               "data_stream_s", "data_levels_s", "advice_build_s", "advice_dev_s", "advice_commit_s",
               "advice_assemble_s", "advice_upload_s", "advice_stream_s", "advice_levels_s",
               "zerochecks_s", "dag_build_s", "zerocheck_host_s", "zerocheck_start_s", "batch_eval_s", "open_s", "unified_s",
               "lasso_s", "witness_dev_s",
               "forest_s", "evals_s", "opens_s", "commitments_s")
    launches_at_2_20 = {}
    v3_launches = {}
    for phase, version, names in ((6, 2, ("v2-nop-2^16", "v2-fibonacci-10000", "v2-nop-2^20")),
                                  (8, 4, ("v4-nop-2^16", "v4-nop-2^20")),
                                  (9, 3, ("v3-nop-2^16", "v3-fibonacci-10000", "v3-nop-2^20"))):
        for name in names:
            program, entry, segments, tape, max_steps, case = load_case(name)
            data, prover, counts, peak, device_work = port_prove_v2(program, entry, segments, tape, max_steps, version)
            if name in N2_LAUNCHES and counts["N2"] != N2_LAUNCHES[name]:
                raise AssertionError(f"{name}: N2 launched {counts['N2']} times, not {N2_LAUNCHES[name]}")
            if name.endswith("nop-2^20"):
                launches_at_2_20[version] = counts
                if device_work["sweep_launches"] > 1000:
                    raise AssertionError(f"{name}: {device_work['sweep_launches']} sweep launches, not a few hundred")
                if version == 2:
                    v2_zerochecks = list(zc_seen)  # phase 9b's DAGs
            elif name == "v2-nop-2^16":
                launches_at_2_16 = counts
            t = prover.last_timings
            check_pinned(name, case, data, t["num_steps"])
            if version == 3:  # the forest: P1 once, P2 once a level (nothing freed, one group)
                v3_launches[name] = counts
                v = (t["num_steps"] - 1).bit_length()
                if t["forest_plan"]["groups"] != 1 or (counts["P1"], counts["P2"]) != (1, v):
                    raise AssertionError(f"{name}: the forest's launches {counts} under {t['forest_plan']} are "
                                         f"not P1 once and P2 {v} times")
            log(f"phase {phase} {name}: steps {t['num_steps']}, {len(data)} B, sha256 {sha(data)[:16]} == pinned, Accept, "
                f"commit paths {t['data_commit_path']}/{t['advice_commit_path']}, launches {counts}, "
                f"DATA commit (total_rows, n, n_e) {t['data_commit_shape']}, ADVICE {t['advice_commit_shape']}")
            log(f"phase {phase} {name} device rounds: zerochecks_s={t['zerochecks_s']} "
                f"dag_build_s={t['dag_build_s']} zerocheck_host_s={t['zerocheck_host_s']} "
                f"zerocheck_start_s={t['zerocheck_start_s']} lasso_s={t['lasso_s']} "
                f"total_s={t['total_s']} advice_dev_s={t['advice_dev_s']} advice_upload_s={t['advice_upload_s']} "
                + " ".join(f"{k}={v}" for k, v in device_work.items())
                + f" planes == host advice columns (held after the prove) peak_device_memory_B={peak}")
            log("  port timings: " + " ".join(f"{k}={t[k]}" for k in v2_keys if k in t)
                + f" steps_per_s={t['num_steps'] / t['total_s']}")
            del data, program
            torch.cuda.empty_cache()
    v2_counts = launches_at_2_20[2]

    # -- phase 9b: the zerocheck kernels against their plain versions ------
    t0 = time.perf_counter()
    results.update(zerocheck_kernel_phase(v2_zerochecks, dev, max_sm_mhz, chain_instr / (babybear.CHAIN + 1), 3))
    del v2_zerochecks
    log(f"phase 9b: Z1 and Z2 == their plain versions at {len(results['z1'])} and {len(results['z2'])} shapes, "
        f"and Z1 on each of the {len(results['z1_programs'])} distinct programs of the v2 2^20 prove "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 7: ligero_commit_device against ligero_commit ---------------
    names = [f"w{k:02d}" for k in range(43)]
    rows = words(43, 1 << 18)
    columns = {name: rows[k].cpu().numpy().astype("uint64") for k, name in enumerate(names)}
    ligero_dev.LAUNCHES.update(columns=0, absorb=0)
    ntt_dev.LAUNCHES.update(dict.fromkeys(ntt_dev.LAUNCHES, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    port_state = ligero_dev.ligero_commit_device(F, names, rows)
    port_s = time.perf_counter() - t0
    columns_launches = ligero_dev.LAUNCHES["columns"]
    commit_device_ntt = {"N1": ntt_dev.LAUNCHES["tile"], "N2": ntt_dev.LAUNCHES["pass"]}
    if not columns_launches or commit_device_ntt != {
            "N1": 1, "N2": len(ntt_dev.n2_passes(port_state.n, port_state.n_e))} or (
            commit_device_ntt["N2"] != N2_LAUNCHES["ligero_commit_device"]):
        raise AssertionError(f"ligero_commit_device did not launch K4, or N1 once and N2 once a pass "
                             f"({N2_LAUNCHES['ligero_commit_device']}): {columns_launches}, {commit_device_ntt}")
    t0 = time.perf_counter()
    ref_state = ligero_commit(F, columns, "sha3")
    ref_s = time.perf_counter() - t0
    if (port_state.root, port_state.leaf_digests, port_state.levels) != (
            ref_state.root, ref_state.leaf_digests, ref_state.levels):
        raise AssertionError("ligero_commit_device differs from the host ligero_commit")
    # Open the state whose matrix and encoded matrix lie on the device, and
    # the host state beside it: the same query row, columns and evaluations.
    point = [int(x) for x in torch.randint(1, P, (18,), generator=gen, device=dev).tolist()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opened = ligero.ligero_prove_eval(port_state, point, FiatShamirTranscript())
    evals = ligero.ligero_column_evals(port_state, point)
    open_s = time.perf_counter() - t0
    ref_opened = ligero.ligero_prove_eval(ref_state, point, FiatShamirTranscript())
    if not ((opened.us[0].c == ref_opened.us[0].c).all() and (opened.columns == ref_opened.columns).all()
            and opened.nodes == ref_opened.nodes and evals == ligero.ligero_column_evals(ref_state, point)):
        raise AssertionError("the opening of the device state differs from the host state's")
    if not ligero.ligero_verify_eval(F, port_state.root, 18, names, evals, point, opened, FiatShamirTranscript()):
        raise AssertionError("ligero_verify_eval rejected the opening of the ligero_commit_device state")
    log(f"phase 7 ligero_commit_device 43 x 2^18 ({port_state.m * 43} x {port_state.n_e} encoded): "
        f"root {port_state.root.hex()[:16]} == ligero_commit, {port_s} s (host ligero_commit {ref_s} s), "
        f"K4 launches {columns_launches}, N1/N2 {commit_device_ntt}; opened through vecmat_device/column_evals_device in {open_s} s "
        f"== the host opening, ligero_verify_eval accepts")

    # -- phase 10: the forest's memory plan, where a reference exists -------
    @contextlib.contextmanager
    def forest_thresholds(discard, group):
        """commitments/device_forest.py's thresholds for the proves inside."""
        shipped = device_forest.DISCARD_DIGESTS, device_forest.GROUP_LEAF_DIGESTS
        device_forest.DISCARD_DIGESTS, device_forest.GROUP_LEAF_DIGESTS = discard, group
        try:
            yield
        finally:
            device_forest.DISCARD_DIGESTS, device_forest.GROUP_LEAF_DIGESTS = shipped

    for name, version in (("v1-nop-2^22", 1), ("v1-fibonacci-150000", 1), ("v3-nop-2^16", 3)):
        program, entry, segments, tape, max_steps, case = load_case(name)
        v = (case["num_steps"] - 1).bit_length()
        # level 3 of the 43 trees is the widest kept; 16 trees a group
        with forest_thresholds(discard=(43 << v) >> 3, group=16 << v):
            if version == 1:
                data, prover, counts = port_prove(program, entry, segments, tape, max_steps)
                if (counts["leaves"], counts["merge"]) != (3 + 3, 3 * v + 3):
                    raise AssertionError(f"{name}: launches {counts} are not those of 3 groups and 3 freed levels")
            else:
                data, prover, counts, _peak, _work = port_prove_v2(program, entry, segments, tape, max_steps, version)
                if (counts["P1"], counts["P2"]) != (3 + 3, 3 * v + 3):
                    raise AssertionError(f"{name}: launches {counts} are not those of 3 groups and 3 freed levels")
                forced_v3_counts = counts
        t = prover.last_timings
        check_pinned(name, case, data, t["num_steps"])
        plan = t["forest_plan"]
        if (plan["discarded_levels"], plan["groups"], plan["group_trees"]) != (3, 3, 16):
            raise AssertionError(f"{name}: the forced plan was not taken: {plan}")
        log(f"phase 10 {name} under a forced plan {plan}: sha256 {sha(data)[:16]} == pinned, {len(data)} B, Accept, "
            f"launches {counts}, forest_s={t['forest_s']} opens_s={t['opens_s']} total_s={t['total_s']}")
        del data, program
        torch.cuda.empty_cache()

    # -- phase 11: 2^25 steps, which the forest cannot hold whole ----------
    kept_forest = {}
    forest_type = prover_module.DeviceMerkleForest

    def keeping_forest(*args, **kwargs):
        kept_forest["forest"] = forest_type(*args, **kwargs)
        return kept_forest["forest"]

    def large_prove(v):
        """One v1 prove at 2^v NOP steps on the default device, verified:
        (proof, prover, K1/K2 launches)."""
        program = NOP * (1 << v)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        keccak.LAUNCHES.update(leaves=0, merge=0)
        prover = zt.Prover(F, seed=0)
        proof = prover.prove(program, 0x1000, None, 2 << v, None, None)
        counts = dict(keccak.LAUNCHES)
        peaks = torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev)
        if prover.device.type != "cuda" or proof.metadata.num_steps != 1 << v:
            raise AssertionError(f"2^{v} steps: proved {proof.metadata.num_steps} steps on {prover.device}")
        t0 = time.perf_counter()
        data = ser.serialize(proof)
        verdict = zt.Verifier(F).verify(ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's proof of 2^{v} steps was rejected: {verdict}")
        t = prover.last_timings
        log(f"phase 11 v1-nop-2^{v}: {len(data)} B, Accept (serialize, deserialize and verify "
            f"{time.perf_counter() - t0:.3f} s), launches {counts}, plan {t['forest_plan']}, "
            f"all levels would hold {43 * ((2 << v) - 1) * 32} B, "
            f"max_memory_allocated {peaks[0]} B, max_memory_reserved {peaks[1]} B")
        log(f"  port timings: {timings(prover)}")
        return proof, prover, counts

    prover_module.DeviceMerkleForest = keeping_forest
    v = 25
    proof, prover, large_counts = large_prove(v)
    prover_module.DeviceMerkleForest = forest_type
    plan = prover.last_timings["forest_plan"]
    if (plan["discarded_levels"], plan["group_trees"], plan["groups"]) != (3, 16, 3):
        raise AssertionError(f"the shipped plan at 2^25 steps is not D = 3 in groups of 16 trees: {plan}")
    if large_counts != {"leaves": 3 + 3, "merge": 3 * v + 3}:
        raise AssertionError(f"2^25 steps: launches {large_counts} are not those of the plan")
    forest = kept_forest.pop("forest")
    t0 = time.perf_counter()
    for i, commitment in enumerate(proof.witness_commitments):
        # tree i alone, every level kept
        level = keccak.sha3_leaves(forest.lo[i].to(torch.int64))
        opening = commitment.proof.merkle_proof
        siblings = []
        for k in range(v):
            siblings.append(level[(opening.index >> k) ^ 1])
            level = keccak.sha3_merge(level.view(-1, 8))
        if keccak.digests_to_bytes(level) != commitment.commitment:
            raise AssertionError(f"2^25 steps: the root of tree {i} differs from the tree built alone")
        want = keccak.digests_to_bytes(torch.stack(siblings))
        if b"".join(opening.path.siblings) != want:
            differ = [k for k in range(v) if opening.path.siblings[k] != want[32 * k : 32 * k + 32]]
            raise AssertionError(f"2^25 steps: tree {i}'s opened siblings differ at levels {differ}")
        if int(forest.lo[i, opening.index]) != opening.value.value:
            raise AssertionError(f"2^25 steps: tree {i}'s opened leaf value differs from the witness")
    log(f"phase 11 v1-nop-2^25: 43 roots and 43 x {v} opened siblings (levels 0..2 recomputed by open_all) == "
        f"each tree built alone by K1/K2 with every level kept ({time.perf_counter() - t0:.3f} s)")
    del forest, proof, level, siblings
    large_prove(24)
    with forest_thresholds(discard=1 << 62, group=1 << 62):
        _proof, prover, counts = large_prove(24)
    if prover.last_timings["forest_plan"]["discarded_levels"] or counts != {"leaves": 1, "merge": 24}:
        raise AssertionError(f"2^24 steps with nothing freed: {prover.last_timings['forest_plan']}, {counts}")
    del _proof
    torch.cuda.empty_cache()

    # -- phase 12: the base-field device zerocheck --------------------------
    n = 1 << 20
    zc_rng = np.random.default_rng(12)
    zc_cols = {name: zc_rng.integers(0, P, size=n, dtype=np.uint64) for name in ("a", "b", "g")}
    zc_cols["__sel__"] = zc_rng.integers(0, 2, size=n, dtype=np.uint64)
    zc_cols["__idx__"] = np.arange(n, dtype=np.uint64)
    zc_tau, zc_gamma = (int(x) for x in zc_rng.integers(1, P, size=2))

    grand_product = make_grand_product(zc_tau, zc_gamma)

    def zerocheck_run(zc_prover):
        transcript = FiatShamirTranscript()
        transcript.append_bytes(b"chip-smoke-zerocheck")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zc = zc_prover.prove(transcript)
        seconds = time.perf_counter() - t0
        return (zc.num_vars, zc.degree, zc.round_evals, zc.final_point, zc.column_evals,
                transcript.challenge_value(P)), seconds

    zerocheck_gen.DEVICE_PROVES.update(count=0, sweep_launches=0)
    device_zc = make_zerocheck_prover(F, zc_cols, grand_product, 4, num_alphas=3, device=dev)
    if not isinstance(device_zc, zerocheck_gen.GenericDeviceZerocheck) or device_zc.device.type != "cuda":
        raise AssertionError(f"make_zerocheck_prover(device=card) gave {type(device_zc).__name__}")
    on_card, card_s = zerocheck_run(device_zc)
    on_host, host_s = zerocheck_run(NativeZerocheckProver(F, zc_cols, grand_product, 4, num_alphas=3))
    if on_card != on_host:
        raise AssertionError("the base-field device zerocheck differs from the native C++ prover")
    card_rounds = 20 - (zerocheck_gen.HOST_TAIL.bit_length() - 1)  # rounds wider than the numpy tail
    if zerocheck_gen.DEVICE_PROVES != {"count": 1, "sweep_launches": card_rounds}:
        raise AssertionError(f"the zerocheck did not run its {card_rounds} card rounds through Z1: "
                             f"{zerocheck_gen.DEVICE_PROVES}")
    log(f"phase 12 base-field zerocheck, 5 columns x 2^20, degree 4: GenericDeviceZerocheck on the card == "
        f"NativeZerocheckProver (20 rounds, terminal evaluations {sorted(on_card[4])}, next challenge equal); "
        f"card {card_s} s with {zerocheck_gen.DEVICE_PROVES['sweep_launches']} launches of Z1 over "
        f"{card_rounds} card rounds, native host prover {host_s} s")

    # -- phase 13: the standalone modules ------------------------------------
    sc_rng = np.random.default_rng(13)
    poly = zt.Multilinear(F, sc_rng.integers(0, P, size=1 << 16, dtype=np.uint64))
    t0 = time.perf_counter()
    sc_proof = zt.SumcheckProver.prove(poly)
    sc_s = time.perf_counter() - t0
    ok, final_claim = zt.SumcheckVerifier.verify_rounds(F, sc_proof, poly.sum_over_hypercube())
    if not ok or final_claim.value != sc_proof.final_eval.value:
        raise AssertionError("SumcheckVerifier.verify_rounds rejected the 2^16 sumcheck proof")
    if zt.SumcheckVerifier.verify_rounds(F, sc_proof, poly.sum_over_hypercube().add(F.one()))[0]:
        raise AssertionError("SumcheckVerifier.verify_rounds accepted a wrong sum")
    table = build_xor_table(F, 4)
    picks = [int(i) for i in sc_rng.integers(0, len(table), size=64)]
    queries = [lasso.LookupQuery(inputs=table.entry(i).inputs, expected_outputs=table.entry(i).outputs)
               for i in picks]
    lasso_proof = lasso.LassoProver.prove_with_mapping(F, table, queries, picks)
    query_sum = F(sum(lasso.hash_entry_chain(F, q.input_values(), q.output_values()).value for q in queries) % P)
    ok, _claim = zt.SumcheckVerifier.verify_rounds(F, lasso_proof.sumcheck_proof, query_sum)
    fast = lasso.LassoVerifier.verify_fast(F, lasso_proof, lasso_proof.table_commitment, len(queries),
                                           lasso_proof.sumcheck_proof.final_eval)
    wrong_table = lasso.LassoVerifier.verify(F, lasso_proof, build_xor_table(F, 3), len(queries))
    if not (ok and fast.is_valid) or wrong_table.is_valid:
        raise AssertionError(f"the Lasso round trip failed: rounds {ok}, {fast.reason}; wrong table: {wrong_table.reason}")
    matrix = sc_rng.integers(0, P, size=(43, 1 << 12), dtype=np.uint64)
    if not host_forest.available():
        raise RuntimeError("zigz_sha3_forest is not in the host runtime")
    t0 = time.perf_counter()
    on_host = host_forest.HostMerkleForest(F, matrix)
    host_forest_s = time.perf_counter() - t0
    on_card = device_forest.DeviceMerkleForest(F, lo=witness_dev.from_numpy(matrix.astype(np.uint32), dev))
    indices = sc_rng.integers(0, 1 << 12, size=43)
    if on_host.roots() != on_card.roots() or any(
            (a.index, a.value.value, a.path.siblings, a.path.directions)
            != (b.index, b.value.value, b.path.siblings, b.path.directions)
            for a, b in zip(on_host.open_all(indices), on_card.open_all(indices))):
        raise AssertionError("HostMerkleForest differs from DeviceMerkleForest at 43 x 2^12")
    log(f"phase 13 standalone: SumcheckProver.prove on 2^16 values in {sc_s:.3f} s, verify_rounds accepts "
        f"({len(sc_proof.to_bytes())} B); Lasso: 64 queries into the 4-bit XOR table, rounds verify, verify_fast "
        f"accepts, another table rejected ({wrong_table.reason}); HostMerkleForest 43 x 2^12 in "
        f"{host_forest_s:.3f} s: roots and 43 openings == DeviceMerkleForest on the card")

    group_launches = group_phases(pinned)

    # -- the contract's lines ----------------------------------------------
    def entry_of(name, key, source, replaces, launches):
        r = results[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "shape": r["shape"],
                "launches_v4": launches_at_2_20[4][key], "launches_v3": launches_at_2_20[3][key],
                "launches_large": large_counts.get(key, 0),
                # per rank, two ranks sharing the card (phase 15)
                "launches_group_v1_2_22": [c[GROUP_KEYS[key]] for c in group_launches["v1-nop-2^22"]],
                "launches_group_v2_2_20": [c[GROUP_KEYS[key]] for c in group_launches["v2-nop-2^20"]]}

    def block_counts(key):
        """K4's or K5's bound counts: a rate block's and a column's own."""
        return {part: {k: unit_counts[f"{part}_{key}"][k] for k in ("issued", "ALU", "FMA", "sm_clocks", "limb")}
                for part in ("block", "column")}

    sha3_source = "zigz_tpu_torch/csrc/sha3_kernels.cu"
    ligero_source = "zigz_tpu_torch/csrc/ligero_kernels.cu"
    # K3, the permutation, is a device function inlined in the four kernels
    # and has no launch of its own: it runs in every launch of K1 and K2, and
    # K2 is exactly one permutation per thread, so its entry carries K2's
    # measurements and the sum of K1's and K2's launches.
    permutation = dict(entry_of("keccak_f1600 (K3)", "merge", "zigz_tpu_torch/csrc/keccak.cuh",
                                "zigz_tpu/ops/keccak_pallas.py:60", main_counts["leaves"] + main_counts["merge"]),
                       inlined_in=["K1", "K2", "K4", "K5"], measured_as="K2: one permutation per thread",
                       launches_large=large_counts["leaves"] + large_counts["merge"],
                       **{f"launches_group_{tag}": [c["K1"] + c["K2"] for c in group_launches[name]]
                          for tag, name in (("v1_2_22", "v1-nop-2^22"), ("v2_2_20", "v2-nop-2^20"))})
    kernels_line = {"kernels": [
        entry_of("sha3_leaves (K1)", "leaves", sha3_source, "zigz_tpu/ops/keccak_pallas.py:93",
                 main_counts["leaves"]),
        entry_of("sha3_merge (K2)", "merge", sha3_source, "zigz_tpu/ops/keccak_pallas.py:108",
                 main_counts["merge"]),
        permutation,
        dict(entry_of("sha3_columns (K4)", "columns", ligero_source, "zigz_tpu/ops/ligero_dev.py:45",
                      group_launches["v2-nop-2^20"][0]["K4"]),
             launches_commit_device=columns_launches, instructions=block_counts("K4"),
             other_shapes=[{k: results[key][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                         "bound_by")}
                           for key in ("columns_data_shard", "columns_commit_device")]),
        dict(entry_of("sha3_absorb (K5)", "absorb", ligero_source, "zigz_tpu/ops/ligero_dev.py:256",
                      v2_counts["absorb"]),
             instructions=block_counts("K5")),
        # A bench kernel with no TPU counterpart: bench.py:61 times an
        # XLA-fused jnp chain of zigz_tpu/ops/babybear.py:91 mont_mul, which
        # reaches no pl.pallas_call.
        {"name": "field_mul_chain (bench headline)", "route": "cuda",
         "source": "zigz_tpu_torch/csrc/field_kernels.cu", "replaces": "bench.py:61",
         "tpu_kernel": None, "launches": chain_launches,
         **{k: results["mul_chain"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "shape")},
         "integer_instructions_an_element": chain_instr},
    ]}
    # The zerocheck kernels replace XLA-fused jit, not a Pallas kernel: their
    # "replaces" names the JAX functions.  Launches from the v2 2^20 prove
    # (the main path), v3 and v4 at 2^20 and v2 at 2^16 beside them.
    shape_keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for key, counter, name, source, replaces in (
            ("z1", "round_sums", "dag_round_sums (Z1, generated for each DAG program)",
             "zigz_tpu_torch/csrc/dag_round.cuh",
             "zigz_tpu/ops/symtrace.py:260 compile_device + zigz_tpu/ops/zerocheck_dev_ext.py:113 _round_sums"),
            ("z2", "fold_planes", "ext_fold (Z2)", "zigz_tpu_torch/csrc/zerocheck_kernels.cu",
             "zigz_tpu/ops/ext4_dev.py:132 ext_fold_dev, :144 ext_fold_base_dev "
             "(zigz_tpu/ops/zerocheck_dev_ext.py:252,278)")):
        first, *rest = results[key]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "tpu_kernel": None, "launches": v2_counts[counter],
                 **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                          "shape")},
                 "launches_v3": launches_at_2_20[3][counter], "launches_v4": launches_at_2_20[4][counter],
                 "launches_v2_2_16": launches_at_2_16[counter],
                 "other_shapes": [{k: e[k] for k in shape_keys} for e in rest]}
        if key == "z1":
            entry.update(generator="zigz_tpu_torch/ops/dag_codegen.py",
                         generated="build/zigz_tpu_torch/dag/<hash>.cu", build=first["build"],
                         other_shapes=[{**{k: e[k] for k in shape_keys}, "build": e["build"]} for e in rest],
                         every_program_of_v2_2_20=[{**{k: e[k] for k in shape_keys}, "build": e["build"]}
                                                   for e in results["z1_programs"]])
        kernels_line["kernels"].append(entry)
    # Poseidon2 (P1-P3; P0 inlined): they replace jitted jnp and the port's
    # torch ops, not a Pallas kernel.  Launches from the v3 2^20 prove (the
    # main path), v3 at 2^16, the fibonacci guest and under phase 10's forced
    # plan beside them.
    p2_source = "zigz_tpu_torch/csrc/poseidon2_kernels.cu"
    measured = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "launches_a_call")
    for key, tag, name, replaces in (
            ("p2_leaves", "P1", "p2_leaves (P1)", "zigz_tpu/ops/poseidon2.py:130 _p2_leaves_jit"),
            ("p2_merge", "P2", "p2_merge (P2)", "zigz_tpu/ops/poseidon2.py:141 _p2_merge_jit"),
            ("p2_absorb", "P3", "p2_absorb (P3)",
             "zigz_tpu/commitments/ligero.py:386-392 (host C++ zigz_p2_matrix_columns; no device counterpart in "
             "zigz_tpu) and the port's torch-op p2_absorb")):
        kernels_line["kernels"].append({
            "name": name, "route": "cuda", "source": p2_source, "replaces": replaces, "tpu_kernel": None,
            "launches": launches_at_2_20[3][tag], **{k: results[key][k] for k in measured},
            "launches_v3_2_16": v3_launches["v3-nop-2^16"][tag],
            "launches_v3_fibonacci": v3_launches["v3-fibonacci-10000"][tag],
            "launches_v3_2_16_forced_plan": forced_v3_counts[tag], "ptxas": p2_ptxas[f"{key}_kernel"],
            **{k: v for k, v in results[key].items() if k.startswith(("wave", "us_a_column"))}})
    # P0, the permutation, is a device function inlined in the three and has
    # no launch of its own: P1 is one permutation a thread, so its entry
    # carries P1's measurements and the sum of the three's launches.
    kernels_line["kernels"].append({
        "name": "zigz_p2_permute (P0)", "route": "cuda", "source": "zigz_tpu_torch/csrc/poseidon2.cuh",
        "replaces": "zigz_tpu/ops/poseidon2.py:116 permute_device", "tpu_kernel": None,
        "launches": sum(launches_at_2_20[3][tag] for tag in ("P1", "P2", "P3")),
        **{k: results["p2_leaves"][k] for k in measured}, "inlined_in": ["P1", "P2", "P3"],
        "measured_as": "P1: one permutation per thread",
        "instructions_a_permutation": {k: p2_count[k] for k in ("issued", "ALU", "FMA", "sm_clocks", "limb")}})
    # E1, the 64-bit fold: no TPU kernel (zigz_tpu evaluates these fields
    # with object-dtype integers on the host).  Launches from the
    # Goldilocks v1 2^22 prove (the slice's full-width run), every wide
    # prove beside them; the measurements are Goldilocks', Mersenne61's
    # beside them.  K1 and K2 gain their launches on the wide proves.
    wide = wide_launches["launches"]
    for entry, tag in zip(kernels_line["kernels"][:2], ("K1", "K2")):
        entry["launches_wide_fields"] = {case: counts[tag] for case, counts in wide.items()}
    gold, m61 = e1_results["Goldilocks"], e1_results["Mersenne61"]
    kernels_line["kernels"].append({
        "name": "mle_fold_u64 (E1)", "route": "cuda", "source": "zigz_tpu_torch/csrc/field64_kernels.cu",
        "replaces": "none: zigz_tpu/poly/multilinear.py:45,53 (object-dtype host evaluation, p >= 2^31) and "
                    "zigz_tpu/ops/mle.py:98 _batch_eval_lsb_jit (jnp, p < 2^31)",
        "tpu_kernel": None, "launches": wide["v1-goldilocks-nop-2^22"]["E1"],
        **{k: gold[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                                "first_fold", "instructions_an_output", "ptxas")},
        "launches_wide_fields": {case: counts["E1"] for case, counts in wide.items()},
        "mersenne61": {k: m61[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "shape",
                                           "first_fold", "instructions_an_output", "ptxas")},
        "full_width_proves": wide_launches["full_width"]})
    # N1 and N2, the Reed-Solomon encode: no TPU kernel (zigz_tpu jits it in
    # jnp).  Launches from the v2 2^20 prove (the main path), v3 and v4 at
    # 2^20, v2 at 2^16, phase 7's ligero_commit_device and the ranks of the
    # sharded v2 2^20 prove beside them; measurements from phase 2d, where
    # the plain version is the whole encode's.
    for key, counter, name in (("n1", "N1", "ntt_tile (N1)"), ("n2", "N2", "ntt_pass (N2)")):
        r = ntt_results[key]
        kernels_line["kernels"].append({
            "name": name, "route": "cuda", "source": "zigz_tpu_torch/csrc/ntt_kernels.cu",
            "replaces": "none: zigz_tpu/ops/ntt_dev.py:107 _encode_jit (the four-step NTT in jitted jnp, no "
                        "pl.pallas_call) and the port's torch-op encode",
            "tpu_kernel": None, "launches": v2_counts[counter],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
            "plain_of": "the whole encode, N1 and N2", "ptxas": ntt_results["ptxas"][NTT_KERNELS[counter]],
            "launches_v3": launches_at_2_20[3][counter], "launches_v4": launches_at_2_20[4][counter],
            "launches_v2_2_16": launches_at_2_16[counter], "launches_commit_device": commit_device_ntt[counter],
            "launches_group_v2_2_20": [c[counter] for c in group_launches["v2-nop-2^20"]],
            **({"ms_each_pass": r["n2_ms"], "bound_ms_each_pass": r["n2_bound_ms"],
                "bound_counts": "every butterfly of the pass's stages; one read and one write of the block"}
               if key == "n2" else {
                "whole_encode": [{k: e[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "launches_a_call",
                                                    "bound_ms", "bound_by", "butterflies")}
                                 for e in ntt_results["ntt"]],
                "instructions_a_butterfly": {k: butterfly[k] for k in ("issued", "ALU", "FMA", "sm_clocks",
                                                                       "limb")}})})
    # W1, the witness rows: no TPU kernel (zigz_tpu builds them in jitted
    # jnp from its host packing).  Its launches are those counted in the
    # proves of phases 5 (v1 2^22) and 6-9 (2^20); the measurements are
    # BabyBear's at the v1-fib-2e22 shape, the two 64-bit fields' beside them.
    kernels_line["kernels"].append({
        "name": "witness_rows (W1)", "route": "cuda", "source": "zigz_tpu_torch/csrc/witness_kernels.cu",
        "replaces": "none: the non-register rows of zigz_tpu/ops/witness_dev.py _build_witness_jit (jnp) and its "
                    "host pack_trace_columns",
        "tpu_kernel": None, "launches": main_counts["W1"], "steps": main_counts["W1_steps"],
        "launches_v2": launches_at_2_20[2]["W1"], "launches_v3": launches_at_2_20[3]["W1"],
        "launches_v4": launches_at_2_20[4]["W1"],
        **{k: w1_results["BabyBear"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "shape", "register_fill_ms", "ptxas")},
        **{name.lower(): {k: w1_results[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "ptxas")}
           for name in ("Goldilocks", "Mersenne61")},
        "build_witness_launches": w1_results["build_witness_launches"]})
    log(json.dumps({"torch_ops": torch_ops}))
    log(json.dumps(kernels_line))
    log(info["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def rank_main(argv) -> int:
    """One rank of phases 14 and 15 (``--rank <job dir> <rank>``): the
    port's worker with the rank functions of tests/torch_group_checks.py,
    jax and zigz_tpu blocked as in the script itself."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch_group_checks  # the rank functions of phases 14 and 15

    torch_group_checks.worker_main(argv, torch_group_checks.FUNCTIONS)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "zigz_tpu") and sys.modules[m] is not None)
    if loaded:
        raise AssertionError(f"a rank imported {loaded}")
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"] else main())
