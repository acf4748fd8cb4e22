"""The port's base-field device zerocheck (ops/zerocheck_gen.py) ==
zigz_tpu's GenericDeviceZerocheck == both packages' host ZerocheckProver ==
the port's native C++ prover.

The cases of tests/test_zerocheck_gen.py.  Round evaluations, challenges,
terminal evaluations and the transcript state are integers and bytes:
tolerance zero.  On the CPU the port's class runs the same torch ops it
runs on a card."""

import numpy as np
import pytest
import torch

from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.core.hash import FiatShamirTranscript as RefTranscript
from zigz_tpu.ops import symtrace as ref_symtrace
from zigz_tpu.ops.zerocheck_gen import GenericDeviceZerocheck as RefDeviceZerocheck
from zigz_tpu.ops.zerocheck_gen import eq_table_device as ref_eq_table_device
from zigz_tpu.ops import babybear as ref_bb
from zigz_tpu.proofs.zerocheck import ZerocheckProver as RefZerocheckProver
from zigz_tpu.proofs.zerocheck import ZerocheckVerifier as RefZerocheckVerifier
import zigz_tpu_torch as zt
from zigz_tpu_torch.core.hash import FiatShamirTranscript
from zigz_tpu_torch.ops import zerocheck_gen
from zigz_tpu_torch.ops.symtrace import TraceError, trace_combiner
from zigz_tpu_torch.ops.zerocheck_gen import GenericDeviceZerocheck, eq_table_device
from zigz_tpu_torch.ops.zerocheck_native import NativeZerocheckProver, native_available
from zigz_tpu_torch.proofs import zerocheck as port_zerocheck
from zigz_tpu_torch.proofs.zerocheck import ZerocheckProver, make_zerocheck_prover

P = F.MODULUS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_grand_product_combiner(tau: int, gamma: int):
    """Structural stand-in for the regcheck/memcheck combiners: fingerprint
    products, public-column mixing, degree-3 gating
    (tests/test_zerocheck_gen.py)."""

    def combiner(cols, alphas, p):
        sel = cols["__sel__"]
        idx = cols["__idx__"]
        a, b, g = cols["a"], cols["b"], cols["g"]
        fp = (tau + p - (a + gamma * b) % p) % p
        c1 = (g * fp + p - sel) % p
        c2 = sel * ((1 + p - sel) % p) % p
        c3 = sel * b % p * ((idx + a) % p) % p
        return (alphas[0] * c1 + alphas[1] * c2 + alphas[2] * c3) % p

    return combiner


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    cols = {
        "__sel__": rng.integers(0, 2, size=n, dtype=np.uint64),
        "__idx__": np.arange(n, dtype=np.uint64),
        "a": rng.integers(0, P, size=n, dtype=np.uint64),
        "b": rng.integers(0, P, size=n, dtype=np.uint64),
        "g": rng.integers(0, P, size=n, dtype=np.uint64),
    }
    cols["a"][0], cols["b"][-1] = P - 1, 0
    return cols, _make_grand_product_combiner(int(rng.integers(1, P)), int(rng.integers(1, P)))


def _prove(prover, transcript_type):
    transcript = transcript_type()
    transcript.append_bytes(b"zcgen-test")
    proof = prover.prove(transcript)
    return (proof.num_vars, proof.degree, proof.round_evals, proof.final_point, proof.column_evals,
            transcript.challenge_value(P))


@pytest.mark.parametrize("n, host_tail", [(256, 16), (256, 1), (64, 1 << 12), (2, 1), (1, 1)])
def test_grand_product_combiner_device_rounds(n, host_tail):
    """Device rounds down to ``host_tail``, then the host tail; with
    host_tail = 1 every round and the terminal evaluations come from the
    device planes, with 2^12 every round runs in the tail."""
    cols, comb = _columns(n, seed=7 + n)
    zerocheck_gen.DEVICE_PROVES.update(count=0, sweep_launches=0)
    port = _prove(GenericDeviceZerocheck(zt.BabyBear, cols, comb, 4, num_alphas=3, host_tail=host_tail,
                                         device="cpu"), FiatShamirTranscript)
    assert zerocheck_gen.DEVICE_PROVES == {"count": 1, "sweep_launches": 0}  # launches are a card's
    assert port == _prove(ZerocheckProver(zt.BabyBear, cols, comb, 4, num_alphas=3), FiatShamirTranscript)
    assert port == _prove(RefZerocheckProver(F, cols, comb, 4, num_alphas=3), RefTranscript)
    if n >= 2:  # zigz_tpu's device class folds at least once
        assert port == _prove(RefDeviceZerocheck(F, cols, comb, 4, num_alphas=3, host_tail=max(host_tail, 2)),
                              RefTranscript)
    if n >= 2 and native_available():
        assert port == _prove(NativeZerocheckProver(zt.BabyBear, cols, comb, 4, num_alphas=3), FiatShamirTranscript)
    # Public __idx__/__sel__ columns must not be reported.
    assert set(port[4]) == {"a", "b", "g"}


def test_a_proof_of_a_vanishing_combination_verifies():
    """Columns on which the combiner does vanish: zigz_tpu's verifier accepts
    the device prover's proof."""
    n = 128
    rng = np.random.default_rng(11)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    cols = {"a": a, "b": b, "c": a * b % np.uint64(P)}

    def comb(c, alphas, p):
        return alphas[0] * ((c["a"] * c["b"] + p - c["c"]) % p) % p

    transcript = FiatShamirTranscript()
    proof = make_zerocheck_prover(zt.BabyBear, cols, comb, 3, num_alphas=1, device="cpu").prove(transcript)
    assert proof.round_evals[0][0] == proof.round_evals[0][1] == 0
    scalar = lambda ev, alphas, p: alphas[0] * ((ev["a"] * ev["b"] - ev["c"]) % p) % p
    assert RefZerocheckVerifier(F, scalar, 1, 3).verify(proof, RefTranscript())


@pytest.mark.parametrize("v", [0, 1, 5])
def test_eq_table_device_matches_both_hosts(v):
    taus = [int(t) for t in np.random.default_rng(v).integers(0, P, size=v)]
    got = eq_table_device(taus, 1 << v, "cpu").numpy().astype(np.uint64)
    assert got.tolist() == port_zerocheck._eq_table(taus, P).tolist()
    if v:
        ref = np.asarray(ref_bb.from_mont(ref_eq_table_device(taus, 1 << v)), dtype=np.uint64)
        assert got.tolist() == ref.tolist()


def test_untraceable_combiner_raises():
    def weird(cols, alphas, p):
        return np.sqrt(cols["x"])  # not ring algebra

    for tracer, error in ((trace_combiner, TraceError), (ref_symtrace.trace_combiner, ref_symtrace.TraceError)):
        with pytest.raises(error):
            tracer(weird, ["x"], [1], P)
    with pytest.raises(TraceError):
        GenericDeviceZerocheck(zt.BabyBear, {"x": np.ones(4, dtype=np.uint64)}, weird, 2, num_alphas=1, device="cpu")


def test_trace_structure_stable_under_challenges():
    names = ["__sel__", "__idx__", "a", "b", "g"]
    t1 = trace_combiner(_make_grand_product_combiner(1, 2), names, [4] * 3, P)
    t2 = trace_combiner(_make_grand_product_combiner(0, P - 1), names, [0] * 3, P)
    assert t1.signature == t2.signature
    assert t1.consts != t2.consts  # values differ, structure does not
    ref = ref_symtrace.trace_combiner(_make_grand_product_combiner(1, 2), names, [4] * 3, P)
    assert (t1.signature, list(t1.consts)) == (ref.signature, list(ref.consts))


def test_challenge_dependent_structure_raises_in_prove():
    """A combiner whose control flow reads a challenge: refused when the
    real alphas give another DAG than the probe's."""

    def comb(c, alphas, p):
        return (alphas[0] * c["x"]) % p if alphas[0] == 1 else (c["x"] * c["x"]) % p

    prover = GenericDeviceZerocheck(zt.BabyBear, {"x": np.zeros(8, dtype=np.uint64)}, comb, 3, num_alphas=1,
                                    device="cpu")
    with pytest.raises(TraceError, match="challenge"):
        prover.prove(FiatShamirTranscript())


def test_make_zerocheck_prover_chooses_by_device():
    cols, comb = _columns(64, seed=3)
    dev = make_zerocheck_prover(zt.BabyBear, cols, comb, 4, num_alphas=3, device="cpu")
    assert isinstance(dev, GenericDeviceZerocheck) and dev.device.type == "cpu"
    host = make_zerocheck_prover(zt.BabyBear, cols, comb, 4, num_alphas=3)
    assert isinstance(host, NativeZerocheckProver if native_available() else ZerocheckProver)
    assert _prove(dev, FiatShamirTranscript) == _prove(host, FiatShamirTranscript)
    # one row wide: nothing to fold, the numpy prover
    one = {k: v[:1] for k, v in cols.items()}
    assert isinstance(make_zerocheck_prover(zt.BabyBear, one, comb, 4, num_alphas=3), ZerocheckProver)


def test_v2_prove_with_every_zerocheck_on_the_device_class_is_byte_identical(monkeypatch):
    """End to end at toy size (the last case of tests/test_zerocheck_gen.py):
    the v2 prove whose zerochecks all run through the device classes, every
    round on the "device" (host tail 4), against zigz_tpu's host provers."""
    from zigz_tpu.prover.prover import Prover as RefProver
    from zigz_tpu.prover.serialization import BinarySerializer as RefSerializer
    from zigz_tpu_torch.lookups import pipeline_lasso
    from zigz_tpu_torch.ops import zerocheck_dev_ext

    # ADDI x1,x0,3; ADDI x2,x0,4; 29 x ADD x3,x1,x2; EBREAK.
    program = (bytes([0x93, 0x00, 0x30, 0x00, 0x13, 0x01, 0x40, 0x00])
               + bytes([0xB3, 0x81, 0x20, 0x00]) * 29 + bytes([0x73, 0x00, 0x10, 0x00]))
    monkeypatch.setattr(zerocheck_dev_ext, "HOST_TAIL_EXT", 4)
    monkeypatch.setattr(pipeline_lasso, "HOST_TAIL", 4)
    zerocheck_dev_ext.reset_counters()
    proof = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2).prove(
        program, 0x1000, None, 1 << 8, None, None)
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == port_zerocheck.count_zerocheck_proofs(proof) > 0
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)

    monkeypatch.setenv("ZIGZ_TPU_ZEROCHECK", "host")
    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")
    ref = RefProver(F, seed=0, protocol_version=2).prove(program, 0x1000, None, 1 << 8, None, None)
    assert data == RefSerializer(F).serialize(ref)
    assert zt.Verifier(zt.BabyBear).verify(proof, program) == "Accept"
