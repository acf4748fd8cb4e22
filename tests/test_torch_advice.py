"""The port's device advice twins (ops/advice_dev.py) and the device-stitched
ADVICE matrix == zigz_tpu's device twins (jnp on the CPU) == the host advice
columns.  Canonical integers and proof bytes, tolerance zero; inputs from a
numpy seed."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigz_tpu.commitments.ligero import DeviceColumnRef as JaxColumnRef
from zigz_tpu.core.ext4 import ext_from_ints
from zigz_tpu.ops import advice_dev as jax_advice
from zigz_tpu.prover.prover import Prover as ReferenceProver
from zigz_tpu.prover.serialization import BinarySerializer
from zigz_tpu.verifier.verifier import Verifier
import zigz_tpu_torch as zt
from zigz_tpu_torch.commitments import ligero as port_ligero
from zigz_tpu_torch.commitments.ligero import DeviceColumnRef, ligero_commit_mixed
from zigz_tpu_torch.constraints.core_arg import CoreV2Argument
from zigz_tpu_torch.constraints.regcheck import RegcheckArgument, extract_access_columns
from zigz_tpu_torch.constraints.v2 import build_logup_columns
from zigz_tpu_torch.core.field import BabyBear as F
from zigz_tpu_torch.core.hash import FiatShamirTranscript
from zigz_tpu_torch.lookups.pipeline_lasso import (
    instruction_registers,
    operand_values,
    system_read_override,
    write_access_values,
)
from zigz_tpu_torch.ops import advice_dev
from zigz_tpu_torch.prover import unified
from zigz_tpu_torch.vm.state import VMState

P = 2013265921
FIXTURES = __import__("pathlib").Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _refs(columns, width=None):
    """One row per column in a 'resident matrix', padded to ``width``: the
    port's refs onto a torch tensor and zigz_tpu's onto a jnp array."""
    names = sorted(columns)
    width = width or max(len(columns[k]) for k in names)
    mat = np.zeros((len(names), width), dtype=np.uint32)
    for i, name in enumerate(names):
        mat[i, : len(columns[name])] = np.asarray(columns[name], dtype=np.uint64).astype(np.uint32)
    port_mat, jax_mat = torch.from_numpy(mat.view(np.int32)), jnp.asarray(mat)
    port = {k: DeviceColumnRef(mat=port_mat, off=i, rows=1, length=len(columns[k])) for i, k in enumerate(names)}
    ref = {k: JaxColumnRef(mat=jax_mat, off=i, rows=1, length=len(columns[k])) for i, k in enumerate(names)}
    return port, ref


def _same_planes(port, reference):
    assert set(port) == set(reference)
    for name in sorted(port):
        assert port[name].dtype == torch.int32
        assert np.array_equal(port[name].numpy().astype(np.uint64), np.asarray(reference[name], dtype=np.uint64)), name


@pytest.mark.parametrize("v, num_steps", [(7, 125), (5, 32), (3, 2), (2, 1)])
def test_core_logup_twin_matches_jax_and_host(v, num_steps):
    """num_steps = 1 makes ``num_steps - 2`` negative: the selectors are
    signed comparisons."""
    rng = np.random.default_rng(5 + v)
    n = 1 << v
    pc = rng.integers(0, P, size=n, dtype=np.uint64)
    next_pc = np.roll(pc, -1)  # a consistent chain, so the host function's self-check passes
    tau = ext_from_ints([int(x) for x in rng.integers(1, P, size=4)])
    beta = ext_from_ints([int(x) for x in rng.integers(1, P, size=4)])
    port_refs, jax_refs = _refs({"pc": pc, "next_pc": next_pc})
    port = advice_dev.core_logup_advice_dev(port_refs["pc"], port_refs["next_pc"], num_steps, v, tau, beta)
    ref = jax_advice.core_logup_advice_dev(jax_refs["pc"], jax_refs["next_pc"], num_steps, v, tau, beta)
    _same_planes(port, ref)
    host = build_logup_columns(pc, next_pc, num_steps, v, tau, beta, P)
    assert host is not None
    for i, g in ((1, host[0]), (2, host[1])):
        for e in range(4):
            assert np.array_equal(port[f"g{i}#{e}"].numpy().astype(np.uint64), g.c[e])


def _regcheck_argument(program, max_steps=64):
    vm = VMState.init(program, 0x1000, None)
    vm.run(max_steps)
    trace = vm.trace
    rs1, rs2, rd = instruction_registers(trace)
    rv1, rv2, _a, _b = operand_values(trace, rs1, rs2, rd)
    wr, ov, wv = write_access_values(trace)
    rs1, rs2, rv1, rv2 = system_read_override(trace, rs1, rs2, rv1, rv2)
    access = extract_access_columns(rs1, rs2, wr, rv1, rv2, ov, wv)
    num_vars = max(1, (len(trace.steps) - 1).bit_length())
    final_regs = [vm.regs.read(i) for i in range(32)]
    return RegcheckArgument(F, access, num_vars, None, final_regs)


_ADDS = bytes([0x93, 0x00, 0x30, 0x00, 0x13, 0x01, 0x40, 0x00]) + bytes([0xB3, 0x81, 0x20, 0x00]) * 9


@pytest.mark.parametrize("program", [bytes([0x13, 0, 0, 0] * 12), _ADDS], ids=["nops", "adds"])
def test_regcheck_twin_matches_jax_and_host(program):
    """The real RegcheckArgument phases on a tiny trace, then both device
    twins against every committed advice coordinate plane."""
    arg = _regcheck_argument(program)
    t = FiatShamirTranscript()
    data_cols = arg.data_phase(t)
    arg.advice_phase(t)
    port_refs, jax_refs = _refs(data_cols, width=1 << 16)
    challenges = (arg.tau_m, arg.tau_r, arg.gamma)
    port = advice_dev.regcheck_advice_dev({k: r for k, r in port_refs.items() if k != "m"}, arg.n, arg.num_vars,
                                          *challenges, port_refs["m"])
    # the two packages have Ext4 classes of their own: the challenges cross as integers
    ref = jax_advice.regcheck_advice_dev({k: r for k, r in jax_refs.items() if k != "m"}, arg.n, arg.num_vars,
                                         *(ext_from_ints(c.to_ints()) for c in challenges), jax_refs["m"])
    _same_planes(port, ref)
    host = {**arg.g_coords, **arg.h_coords}
    _same_planes(port, host)


def test_regcheck_twin_keeps_ts_below_p():
    with pytest.raises(ValueError, match="below p"):
        advice_dev.regcheck_advice_dev({}, 1, 29, None, None, None, None)


def _mixed_columns(seed):
    rng = np.random.default_rng(seed)
    sizes = {"a": 1 << 9, "b": 1 << 4, "c": 1 << 7, "d": 1, "e": 1 << 9, "f": 1 << 6, "g": 1 << 2}
    return {k: rng.integers(0, P, size=ln, dtype=np.uint64) for k, ln in sizes.items()}


@pytest.mark.parametrize("on_device", [("a", "b", "d"), ("c", "e", "f", "g"), tuple("abcdefg")],
                         ids=["long+short", "others", "all"])
@pytest.mark.parametrize("hash_mode", ["sha3", "poseidon2"])
def test_assemble_mat_dev_matches_the_host_matrix(on_device, hash_mode):
    """Columns longer than a row, shorter than a row (zero padded) and of one
    value, some placed from device tensors and the rest uploaded."""
    cols = _mixed_columns(3)
    host = ligero_commit_mixed(F, cols, hash_mode, device="cpu")
    dev_columns = {k: torch.from_numpy(cols[k].astype(np.int64)).to(torch.int32) for k in on_device}
    port_ligero.STITCHED.update(dev_columns=0, host_rows=0)
    port = ligero_commit_mixed(F, cols, hash_mode, device="cpu", dev_columns=dev_columns)
    assert torch.equal(port.encoded.mat_dev, host.encoded.mat_dev)
    assert np.array_equal(port.encoded.mat_dev.numpy().view(np.uint32), port.matrix.astype(np.uint32))
    assert (port.root, port.leaf_digests, port.levels) == (host.root, host.leaf_digests, host.levels)
    assert port.commit_path == "stream-dev"
    host_rows = sum(port.heights[k] for k in cols if k not in on_device)
    assert port_ligero.STITCHED == {"dev_columns": len(on_device), "host_rows": host_rows}


def test_assemble_mat_dev_refuses_a_wrong_column():
    cols = _mixed_columns(4)
    short = torch.zeros(len(cols["a"]) // 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="device column a"):
        ligero_commit_mixed(F, cols, device="cpu", dev_columns={"a": short})
    with pytest.raises(ValueError, match="not columns of this commitment"):
        ligero_commit_mixed(F, cols, device="cpu", dev_columns={"zz": short})


def _spy_on_advice_commit(monkeypatch):
    """Record (host columns, device columns) of every commit that is handed
    device columns."""
    seen = []
    commit = unified.ligero_commit_mixed

    def spy(F_, columns, hash_mode="sha3", *, device, dev_columns=None):
        if dev_columns:
            seen.append((columns, dev_columns))
        return commit(F_, columns, hash_mode, device=device, dev_columns=dev_columns)

    monkeypatch.setattr(unified, "ligero_commit_mixed", spy)
    return seen


def _program(case):
    if case == "nop 2^8":
        return bytes([0x13, 0, 0, 0] * (1 << 8)), 0x1000, None, None
    program = (FIXTURES / "fibonacci_program.bin").read_bytes()
    loaded = zt.elf.load(program)
    return program, loaded.entry_pc, loaded.segments, [10]


@pytest.mark.parametrize("case", ["nop 2^8", "fibonacci [10]"])
def test_v2_prove_device_planes_equal_the_host_advice_columns(case, monkeypatch):
    """All three twins (core, regcheck, bytecode: loads, stores and
    branches in the fibonacci guest) against the host advice columns of the
    same prove, plane by plane."""
    seen = _spy_on_advice_commit(monkeypatch)
    program, entry, segments, tape = _program(case)
    prover = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2)
    proof = prover.prove(program, entry, None, 1 << 16, segments, tape)
    assert zt.Verifier(zt.BabyBear).verify(proof, program) == "Accept"
    (columns, dev_columns), = seen
    assert {name.split(":")[0] for name in dev_columns} == {"v2", "rc", "bc"}
    assert len(dev_columns) == prover.last_timings["advice_dev_cols"] == 148
    assert set(dev_columns) < set(columns)  # h_prog and the query-link advice stay host-built
    for name, plane in dev_columns.items():
        assert np.array_equal(plane.numpy().astype(np.uint64), np.asarray(columns[name], dtype=np.uint64)), name
    assert prover.last_timings["advice_dev_s"] > 0


def _jax_device_advice_prove(program, monkeypatch):
    """zigz_tpu's v2 prove with its device advice twins and its device commit
    path forced on, as tests/test_advice_dev.py runs them on the CPU: the
    Pallas column hasher needs a TPU, so the bit-equal host encode + hash
    stands in for it."""
    from zigz_tpu.commitments.ligero import _hash_columns, ntt_pow2_u32
    from zigz_tpu.ops import ligero_dev as jax_ligero_dev

    def host_equiv(mat_dev, n_e):
        return _hash_columns(ntt_pow2_u32(np.asarray(mat_dev).astype(np.uint64), n_e), "sha3")

    monkeypatch.setattr(jax_ligero_dev, "sha3_columns_stream_device", host_equiv)
    monkeypatch.setenv("ZIGZ_TPU_ADVICE", "device")
    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "device")
    prover = ReferenceProver(F, seed=0, protocol_version=2)
    proof = prover.prove(program, 0x1000, None, 2 * len(program) // 4, None, None)
    return BinarySerializer(F).serialize(proof), prover.last_timings


def test_v2_prove_with_device_advice_matches_zigz_tpu_device_advice(monkeypatch):
    """Byte-identical to zigz_tpu run with ZIGZ_TPU_ADVICE=device, with the
    same count of device-built planes; the spy shows that v2, rc and bc all
    produced planes."""
    program = bytes([0x13, 0, 0, 0] * (1 << 8))
    seen = _spy_on_advice_commit(monkeypatch)
    port = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2)
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(
        port.prove(program, 0x1000, None, 1 << 9, None, None))
    ref_data, ref_timings = _jax_device_advice_prove(program, monkeypatch)
    assert hashlib.sha256(data).digest() == hashlib.sha256(ref_data).digest()
    assert ref_timings["advice_dev_cols"] == port.last_timings["advice_dev_cols"] == 148
    assert "advice_dev_failed" not in ref_timings
    assert {name.split(":")[0] for _, dev in seen for name in dev} == {"v2", "rc", "bc"}
    assert Verifier(F).verify(BinarySerializer(F).deserialize(data), program) == "Accept"


def test_a_failing_device_advice_twin_fails_the_prove(monkeypatch):
    """zigz_tpu logs, records ``advice_dev_failed`` and uploads the host
    columns; the port has no way back."""
    def boom(self, data_state):
        raise RuntimeError("forced device-advice failure")

    monkeypatch.setattr(CoreV2Argument, "device_advice", boom)
    program = bytes([0x13, 0, 0, 0] * 16)
    with pytest.raises(RuntimeError, match="forced device-advice failure"):
        zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2).prove(program, 0x1000, None, 64, None, None)


def test_a_column_that_is_not_resident_is_an_error():
    """zigz_tpu's twins return None for it and the host columns are
    uploaded; the port raises."""
    # a uniform commitment keeps no mixed layout, so it offers no column
    state = port_ligero.ligero_commit(F, {"v2:pc": np.arange(16, dtype=np.uint64)})
    assert state.device_column("v2:pc") is None
    arg = CoreV2Argument.__new__(CoreV2Argument)
    with pytest.raises(RuntimeError, match="v2:pc is not resident"):
        arg.device_advice(state)
    with pytest.raises(RuntimeError, match="not resident"):
        advice_dev.bytecode_advice_dev(state, None, 4)
