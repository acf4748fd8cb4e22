"""The port's own serializer and ``Verifier`` held directly: the tamper cases
of tests/test_v2_protocol.py and byte mutations of tests/test_proof_fuzz.py's
kind, against proofs made by the port (``device="cpu"``).  Every tampered
proof and every corrupted image goes through both packages, and the port must
answer as zigz_tpu does: the same verdict, or an exception of the same type.
Nothing accepts."""

import numpy as np
import pytest
import torch

from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.prover.serialization import BinarySerializer as JaxSerializer
from zigz_tpu.prover.serialization import SerializationError as JaxSerializationError
from zigz_tpu.verifier.verifier import ProgramHashMismatch as JaxProgramHashMismatch
from zigz_tpu.verifier.verifier import Verifier as JaxVerifier
import zigz_tpu_torch as zt
from zigz_tpu_torch.prover.serialization import SerializationError
from zigz_tpu_torch.verifier.verifier import ProgramHashMismatch

PROGRAM = (
    bytes([0x93, 0x00, 0x30, 0x00, 0x13, 0x01, 0x40, 0x00])
    + bytes([0xB3, 0x81, 0x20, 0x00]) * 29
    + bytes([0x73, 0x00, 0x10, 0x00])
)
ALLOWED = (SerializationError, ProgramHashMismatch, JaxSerializationError, JaxProgramHashMismatch,
           ValueError, IndexError, KeyError, OverflowError, AssertionError, MemoryError)
PACKAGES = {
    "port": (zt.serialization.BinarySerializer(zt.BabyBear), zt.Verifier(zt.BabyBear)),
    "jax": (JaxSerializer(F), JaxVerifier(F)),
}


@pytest.fixture(scope="module")
def images():
    """{version: the port's serialized proof of PROGRAM}."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ser = PACKAGES["port"][0]
        return {
            version: ser.serialize(zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=version).prove(
                PROGRAM, 0x1000, None, 1 << 8, None, None))
            for version in (1, 2)
        }
    finally:
        torch.set_num_threads(threads)


def _outcome(package, data, tamper=None, program=PROGRAM):
    """The verdict, or the name of the controlled exception, of one package."""
    ser, verifier = PACKAGES[package]
    try:
        proof = ser.deserialize(data)
        if tamper is not None:
            tamper(proof)
        return str(verifier.verify(proof, program))
    except ALLOWED as exc:
        return type(exc).__name__


def test_untampered_proofs_are_accepted_and_round_trip(images):
    for version, data in images.items():
        assert _outcome("port", data) == _outcome("jax", data) == "Accept"
        ser = PACKAGES["port"][0]
        assert ser.serialize(ser.deserialize(data)) == data
        assert ser.deserialize(data).metadata.version == version


def _bump(x):
    return x + 1


def _tamper_round(proof):
    proof.v2.zerocheck.round_evals[1][2] = _bump(proof.v2.zerocheck.round_evals[1][2])


def _tamper_column_eval(proof):
    proof.v2.column_evals["pc"] = _bump(proof.v2.column_evals["pc"])


def _tamper_advice_root(proof):
    root = bytearray(proof.v2.unified.advice_root)
    root[0] ^= 1
    proof.v2.unified.advice_root = bytes(root)


def _tamper_nonce(proof):
    proof.v2.logup_nonce = (1 << 16) + 1


def _tamper_opening_point(proof):
    wc = proof.witness_commitments[3]
    wc.point[0] = wc.point[0].add(type(wc.point[0])(1))


def _tamper_data_root(proof):
    proof.v2.unified.data_root = bytes(32)


def _tamper_missing_pcs(proof):
    proof.v2.unified.data_open = None


def _tamper_pcs_column(proof):
    op = proof.v2.unified.data_open
    op.columns[3][1] = (int(op.columns[3][1]) + 1) % F.MODULUS


def _tamper_missing_regcheck(proof):
    proof.v2.regcheck = None


def _tamper_regcheck_sum(proof):
    proof.v2.regcheck.g_sums["g_r1"] = _bump(proof.v2.regcheck.g_sums["g_r1"])


def _tamper_regcheck_final_ts(proof):
    proof.v2.regcheck.final_ts[5] = (proof.v2.regcheck.final_ts[5] + 1) % (1 << 32)


def _tamper_missing_memcheck(proof):
    proof.v2.memcheck = None


def _tamper_missing_bytecode(proof):
    proof.v2.bytecode = None


def _tamper_lasso_sum(proof):
    table_id = sorted(proof.v2.lasso_extras)[0]
    proof.v2.lasso_extras[table_id]["claimed_sum"] = (proof.v2.lasso_extras[table_id]["claimed_sum"] + 1) % F.MODULUS


def _tamper_batch_round(proof):
    proof.v2.unified.batch.round_evals[0][0] = _bump(proof.v2.unified.batch.round_evals[0][0])


V2_TAMPERS = {
    "round": (_tamper_round, "RejectInvalidSumcheck"),
    "column_eval": (_tamper_column_eval, "RejectInvalidSumcheck"),
    "advice_root": (_tamper_advice_root, None),
    "oversized_nonce": (_tamper_nonce, None),
    "opening_point": (_tamper_opening_point, "RejectInvalidCommitment"),
    "data_root": (_tamper_data_root, None),
    "missing_pcs": (_tamper_missing_pcs, "RejectInvalidCommitment"),
    "pcs_column": (_tamper_pcs_column, "RejectInvalidCommitment"),
    "missing_regcheck": (_tamper_missing_regcheck, "RejectInvalidRegisterAccess"),
    "regcheck_sum": (_tamper_regcheck_sum, "RejectInvalidRegisterAccess"),
    "regcheck_final_ts": (_tamper_regcheck_final_ts, "RejectInvalidRegisterAccess"),
    "missing_memcheck": (_tamper_missing_memcheck, None),
    "missing_bytecode": (_tamper_missing_bytecode, None),
    "lasso_sum": (_tamper_lasso_sum, None),
    "batch_round": (_tamper_batch_round, None),
}


@pytest.mark.parametrize("name", sorted(V2_TAMPERS))
def test_v2_tampered_proof_is_rejected_as_by_the_jax_package(images, name):
    tamper, verdict = V2_TAMPERS[name]
    got = _outcome("port", images[2], tamper)
    assert got != "Accept"
    assert got == _outcome("jax", images[2], tamper)
    if verdict is not None:
        assert got == verdict


def _tamper_v1_root(proof):
    root = bytearray(proof.witness_commitments[0].commitment)
    root[5] ^= 0x10
    proof.witness_commitments[0].commitment = bytes(root)


def _tamper_v1_value(proof):
    wc = proof.witness_commitments[7]
    wc.value = wc.value.add(type(wc.value)(1))


def _tamper_v1_sibling(proof):
    path = proof.witness_commitments[2].proof.merkle_proof.path
    path.siblings[0] = bytes(32)


@pytest.mark.parametrize("tamper", [_tamper_v1_root, _tamper_v1_value, _tamper_v1_sibling],
                         ids=["root", "opening_value", "sibling"])
def test_v1_tampered_proof_is_rejected_as_by_the_jax_package(images, tamper):
    got = _outcome("port", images[1], tamper)
    assert got != "Accept" and got == _outcome("jax", images[1], tamper)


def _flip_positions(data, version, count):
    rng = np.random.default_rng(version)
    positions = set(int(p) for p in rng.integers(0, len(data), size=count))
    positions.update(range(0, 16))  # header: magic/version/modulus
    return sorted(positions)


@pytest.mark.parametrize("chunk", range(4))
def test_v2_bitflips_never_accept_and_fail_as_in_the_jax_package(images, chunk):
    """Every byte of a v2 image is load-bearing: about 230 single-bit
    mutations over the four chunks, none accepted by the port's verifier;
    the first chunk's are also answered by the port as by zigz_tpu."""
    data = images[2]
    for pos in _flip_positions(data, 2, 100)[chunk::4]:
        for bit in (0x01, 0x80):
            corrupted = bytearray(data)
            corrupted[pos] ^= bit
            got = _outcome("port", bytes(corrupted))
            assert got != "Accept", f"flipped bit {bit:#x} at byte {pos} still accepted"
            if chunk == 0:
                assert got == _outcome("jax", bytes(corrupted)), f"bit {bit:#x} at byte {pos}"


def test_v1_bitflips_fail_cleanly_and_as_in_the_jax_package(images):
    """A v1 image carries fields no verifier checks (the reference's format),
    so a flip may still verify; it must never crash, and the port must
    answer as zigz_tpu does."""
    data = images[1]
    for pos in _flip_positions(data, 1, 100):
        corrupted = bytearray(data)
        corrupted[pos] ^= 0x01
        assert _outcome("port", bytes(corrupted)) == _outcome("jax", bytes(corrupted)), f"byte {pos}"


def test_truncations_fail_cleanly(images):
    data = images[2]
    rng = np.random.default_rng(7)
    for cut in sorted(set(int(c) for c in rng.integers(1, len(data), size=24))):
        got = _outcome("port", data[:cut])
        assert got != "Accept" and got == _outcome("jax", data[:cut])
        with pytest.raises(ALLOWED):
            PACKAGES["port"][0].deserialize(data[:cut])


def test_wrong_program_rejected(images):
    other = PROGRAM[:-4] + bytes([0x13, 0x00, 0x00, 0x00])
    proof = PACKAGES["port"][0].deserialize(images[2])
    with pytest.raises(ProgramHashMismatch):
        PACKAGES["port"][1].verify(proof, other)
    assert _outcome("port", images[2], program=other) == _outcome("jax", images[2], program=other) \
        == "ProgramHashMismatch"
