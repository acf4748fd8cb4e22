"""The zerocheck DAGs of a v3 prove (Poseidon2 commitments) through the
round-sum kernel's program on the CPU, as tests/test_torch_dag_kernels.py
holds v2's and v4's: the encoded program's reference interpreter against
``compile_dag`` at every point, the generator's limits, and zigz_tpu's
``compile_device`` (op by op) on the DAGs of 300 to 750 nodes, which the
other file leaves out.  A file of its own because the v3 prove's Poseidon2
commits take most of its time on the CPU.  Tolerance zero."""

import numpy as np
import pytest
import torch

from torch_dag_programs import P, check_program, jax_lanes, prove_dags, random_planes
from zigz_tpu_torch.ops import symtrace


@pytest.fixture(scope="module")
def dags():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several pytest workers on a few cores
    try:
        yield prove_dags(3)
    finally:
        torch.set_num_threads(threads)


def test_v3_program_of_every_dag_matches_compile_dag(dags):
    assert len(dags) == 24  # 12 zerochecks x (round 0, later rounds)
    rng = np.random.default_rng(3)
    seen = set()
    for _label, nodes, outs, row_of, degree, n_consts in dags:
        key = (tuple(nodes), outs, tuple(sorted(row_of.items())))
        if key in seen:
            continue
        seen.add(key)
        planes = random_planes(rng, max(row_of.values()) + 1, 16)
        check_program(nodes, outs, row_of, degree, [int(x) for x in rng.integers(0, P, size=n_consts)], planes)


def test_v3_mid_sized_dags_match_zigz_tpu_compile_device(dags):
    rng = np.random.default_rng(33)
    seen, checked = set(), 0
    for label, nodes, outs, row_of, _degree, n_consts in dags:
        if not 300 < len(nodes) <= 750 or tuple(nodes) in seen:
            continue
        seen.add(tuple(nodes))
        consts = [int(x) for x in rng.integers(0, P, size=n_consts)]
        planes = random_planes(rng, max(row_of.values()) + 1, 8)
        program = symtrace.compile_device(nodes, outs, row_of)
        lanes, _sums = symtrace._run_program_reference(program, program.constants(consts), planes, 1)
        np.testing.assert_array_equal(jax_lanes(nodes, outs, row_of, consts, planes[:, :4]), lanes[0], label)
        checked += 1
    assert checked >= 3
