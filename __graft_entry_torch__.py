"""Entry points of the PyTorch/CUDA port for a harness: a single-device
proving step, and a multi-rank dry run of the real pipeline.

Twin of ``__graft_entry__.py`` for ``zigz_tpu_torch``.  Nothing here imports
JAX or ``zigz_tpu``.  The ranks of the dry run are processes joined by
``torch.distributed`` (gloo), started by ``zigz_tpu_torch.parallel.launch``.
Both entry points run on the card unless the caller asks for the CPU: by
default the ranks share the one card (``"cuda:0"``) and launch the kernels,
and without a card they raise; on ``device="cpu"`` they run the kernels'
plain versions.

    python -c "import __graft_entry_torch__ as g; g.dryrun_multichip(2)"
    python -c "import __graft_entry_torch__ as g; g.dryrun_multichip(2, device='cpu')"
"""

from __future__ import annotations

import hashlib
import tempfile
import time


def entry(device: str = "cuda"):
    """-> (fn, example_args): the proving step on one device, B = 43 rows of
    2^10 values (canonical int64)."""
    import numpy as np
    import torch

    from zigz_tpu_torch.device import resolve_device
    from zigz_tpu_torch.ops import babybear as bb
    from zigz_tpu_torch.parallel.dist import device_prove_step

    dev = resolve_device(device)
    B, v = 43, 10
    rng = np.random.default_rng(0)

    def draw(shape):
        return torch.from_numpy(rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(np.int64)).to(dev)

    return device_prove_step, (draw((B, 1 << v)), draw((B, v)), draw(1))


def dryrun_multichip(n_ranks: int, device: str = "cuda:0", log2_steps: int = 14) -> None:
    """Prove a REAL program through the full pipeline on ``n_ranks`` ranks.

    The group shards every hypercube-axis device computation (witness
    build, 43-tree Merkle forest, opening evaluations, the v2 commits, batch
    evaluation and Lasso rounds) via ``Prover(group=...)``; every rank's
    proof bytes must be identical to the single-device prover's and the
    verifier must accept, for BOTH protocol v1 (wire parity) and v2 (real
    zerocheck + Lasso), and both v2 commits must have run sharded.  A
    standalone distributed sumcheck of 2^10 values runs as well, to drive
    the all_reduce and the cyclic gather across several rounds."""
    from zigz_tpu_torch.core.field import BabyBear as F
    from zigz_tpu_torch.parallel.jobs import make_program, seeded
    from zigz_tpu_torch.parallel.launch import launch
    from zigz_tpu_torch.poly.multilinear import Multilinear
    from zigz_tpu_torch.proofs.sumcheck import SumcheckProver
    from zigz_tpu_torch.prover.prover import Prover
    from zigz_tpu_torch.prover.serialization import BinarySerializer
    from zigz_tpu_torch.verifier.verifier import Verifier

    t0 = time.perf_counter()

    def stage(msg: str) -> None:
        print(f"[dryrun +{time.perf_counter() - t0:7.1f}s] {msg}", flush=True)

    # ADDI x1,x0,3; ADDI x2,x0,4; (2^k - 3) x ADD x3,x1,x2; EBREAK
    # -> exactly 2^k executed steps (k = 14: 16384).
    n_steps = 1 << log2_steps
    program_spec = {"kind": "arith", "adds": n_steps - 3}
    program = make_program(program_spec)
    max_steps = n_steps * 2
    ser = BinarySerializer(F)

    single = {}
    for version in (1, 2):
        stage(f"single-device v{version} prove (reference bytes)")
        proof = Prover(F, seed=0, device=device, protocol_version=version).prove(
            program, 0x1000, None, max_steps, None, None)
        assert Verifier(F).verify(proof, program) == "Accept"
        single[version] = hashlib.sha256(ser.serialize(proof)).hexdigest()

    with tempfile.TemporaryDirectory(prefix="zigz_dryrun_") as work_dir:
        for version in (1, 2):
            stage(f"sharded v{version} prove ({n_ranks} ranks on {device})")
            results = launch(n_ranks, "prove",
                             {"program": program_spec, "max_steps": max_steps, "protocol_version": version},
                             work_dir=work_dir, device=device, timeout_s=1800)
            for res in results:
                assert res["num_steps"] == n_steps
                assert res["sha256"] == single[version], f"sharded v{version} proof bytes diverged on rank {res['rank']}"
                assert res["verify"] == "Accept"
            if version == 2:
                timings = results[0]["timings"]
                assert timings.get("data_commit_sharded") is True, "v2 DATA commit did not shard under the group"
                assert timings.get("advice_commit_sharded") is True, "v2 ADVICE commit did not shard under the group"
                print("[dryrun] v2 sharded phases:", {
                    k: (round(v, 3) if isinstance(v, float) else v)
                    for k, v in timings.items()
                    if k in ("data_commit_s", "data_commit_sharded", "advice_commit_s", "advice_commit_sharded",
                             "batch_eval_s", "batch_eval_sharded", "zerochecks_s", "zerochecks_sharded",
                             "open_s", "open_sharded")
                }, flush=True)

        stage("standalone distributed sumcheck")
        v = 10
        host = SumcheckProver.prove(Multilinear(F, seeded(0, 1 << v))).to_bytes().hex()
        results = launch(n_ranks, "sumcheck", {"seed": 0, "log2_n": v},
                         work_dir=work_dir, device=device, timeout_s=600)
        for res in results:
            assert res["num_vars"] == v and res["hex"] == host, "distributed sumcheck diverged from the host prover"

    print(
        f"dryrun_multichip OK: {n_ranks} ranks on {device}, REAL pipeline "
        f"({n_steps} steps, v1+v2 byte-identical sharded "
        f"proofs, both verified), sumcheck {v} rounds"
    )
