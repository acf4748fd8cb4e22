"""The port's GenericDeviceZerocheckExt (torch ops) == zigz_tpu's numpy and
native extension zerochecks.

The cases of tests/test_zerocheck_dev_ext.py, run as that file runs its
references (``ZIGZ_TPU_ZEROCHECK=host`` for zigz_tpu's numpy prover,
``native`` for its C++ twin): same transcript bytes, same ``ZerocheckProof``.
The two packages have classes of their own, so proofs are compared by
their canonical integers.  Tolerance zero."""

import numpy as np
import pytest
import torch

from zigz_tpu.core import ext4 as ref_ext4
from zigz_tpu.core.field import BabyBear as RefBabyBear
from zigz_tpu.core.hash import FiatShamirTranscript as RefTranscript
from zigz_tpu.proofs.zerocheck import ZerocheckExtProver as RefZerocheckExtProver
from zigz_tpu_torch.commitments.ligero import ligero_commit_mixed
from zigz_tpu_torch.core.ext4 import Ext4, ext_from_ints
from zigz_tpu_torch.core.field import BabyBear
from zigz_tpu_torch.core.hash import FiatShamirTranscript
from zigz_tpu_torch.ops import symtrace, zerocheck_dev_ext
from zigz_tpu_torch.ops.zerocheck_dev_ext import GenericDeviceZerocheckExt
from zigz_tpu_torch.proofs.zerocheck import ZerocheckExtProver, ZerocheckExtVerifier

P = 2013265921


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mk_columns(v, seed=0, with_ext=True):
    """Columns satisfying a*b - c == 0 plus a free ext column, as raw
    arrays; the values 0 and p - 1 are among them."""
    rng = np.random.default_rng(seed)
    n = 1 << v
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    a[:2] = [0, P - 1]
    b[:2] = [P - 1, P - 1]
    cols = {"a": a, "b": b, "c": a * b % np.uint64(P)}
    if with_ext:
        cols["g"] = rng.integers(0, P, size=(4, n), dtype=np.uint64)
    return cols


def _typed(cols, ext_cls):
    return {k: (ext_cls(v) if v.ndim == 2 else v) for k, v in cols.items()}


def _combiner(cols, alphas, p):
    # alpha0 * (a*b - c)  [vanishes]  + alpha1 * (g - g)  [vanishes]
    t0 = (cols["a"] * cols["b"] % p + p - cols["c"]) % p
    z = (cols["g"] + p - cols["g"]) % p if "g" in cols else 0
    return (alphas[0] * t0 + alphas[1] * z) % p


def _base_combiner(cols, alphas, p):
    return alphas[0] * ((cols["a"] * cols["b"] % p + p - cols["c"]) % p) % p


def _reference(backend, cols, monkeypatch, combiner=_combiner, degree=3, num_alphas=2):
    """zigz_tpu's numpy ("host") or C++ ("native") prover."""
    monkeypatch.setenv("ZIGZ_TPU_ZEROCHECK", backend)
    t = RefTranscript()
    t.append_bytes(b"ZC_DEV_TEST")
    proof = RefZerocheckExtProver(RefBabyBear, _typed(cols, ref_ext4.Ext4), combiner, degree,
                                  num_alphas=num_alphas).prove(t)
    return proof, t.finalize()


def _device(cols, host_tail, combiner=_combiner, degree=3, num_alphas=2, dev_columns=None):
    t = FiatShamirTranscript()
    t.append_bytes(b"ZC_DEV_TEST")
    proof = GenericDeviceZerocheckExt(BabyBear, _typed(cols, Ext4), combiner, degree, num_alphas=num_alphas,
                                      dev_columns=dev_columns, host_tail=host_tail, device="cpu").prove(t)
    return proof, t.finalize()


def _ints(proof):
    return (
        proof.num_vars, proof.degree,
        [[g.to_ints() for g in r] for r in proof.round_evals],
        [r.to_ints() for r in proof.final_point],
        {k: v.to_ints() for k, v in sorted(proof.column_evals.items())},
    )


def _assert_equal(pa, da, pb, db):
    assert da == db, "transcript digests differ"
    assert _ints(pa) == _ints(pb)


@pytest.mark.parametrize("v", [1, 4, 7, 10])
def test_device_matches_host_numpy(v, monkeypatch):
    cols = _mk_columns(v)
    _assert_equal(*_reference("host", cols, monkeypatch), *_device(cols, host_tail=1 << 3))


def test_device_matches_native(monkeypatch):
    cols = _mk_columns(9, seed=3)
    _assert_equal(*_reference("native", cols, monkeypatch), *_device(cols, host_tail=1 << 4))


@pytest.mark.parametrize("tail", [2, 8, 32, 64, None])
def test_device_tail_boundaries(tail, monkeypatch):
    """All rounds but the last on the device, mixed, and effectively all on
    the host (None: the default 2^12) agree with the numpy prover."""
    cols = _mk_columns(6, seed=7)
    _assert_equal(*_reference("host", cols, monkeypatch), *_device(cols, host_tail=tail))


def test_device_base_only_columns(monkeypatch):
    cols = _mk_columns(8, seed=11, with_ext=False)
    ref = _reference("host", cols, monkeypatch, combiner=_base_combiner, num_alphas=1)
    _assert_equal(*ref, *_device(cols, host_tail=4, combiner=_base_combiner, num_alphas=1))


def test_device_chunked_sweep(monkeypatch):
    """A sweep wider than SWEEP_CHUNK runs in chunks with the same sums."""
    cols = _mk_columns(8, seed=12)
    ref = _reference("host", cols, monkeypatch)
    monkeypatch.setattr(zerocheck_dev_ext, "SWEEP_CHUNK", 16)
    _assert_equal(*ref, *_device(cols, host_tail=4))


def test_device_dev_columns_resident(monkeypatch):
    """Base columns read from a commitment's resident matrix (the path of
    the unified pipeline) give identical results; only the column that is
    in no commitment is uploaded."""
    cols = _mk_columns(8, seed=13)
    state = ligero_commit_mixed(BabyBear, {"a": cols["a"], "b": cols["b"], "pad": cols["c"][:16]}, device="cpu")
    refs = {name: state.device_column(name) for name in ("a", "b")}
    assert all(ref is not None and ref.length == 1 << 8 for ref in refs.values())
    assert state.device_column("c") is None
    zerocheck_dev_ext.reset_counters()
    got = _device(cols, host_tail=8, dev_columns=refs)
    assert zerocheck_dev_ext.COLUMNS == {"resident": 2, "uploaded": 1}
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == 1 and zerocheck_dev_ext.DEVICE_PROVES["sweep_launches"] > 0
    _assert_equal(*_reference("host", cols, monkeypatch), *got)


def test_device_proof_verifies():
    cols = _mk_columns(8, seed=17)
    proof, digest = _device(cols, host_tail=8)
    tv = FiatShamirTranscript()
    tv.append_bytes(b"ZC_DEV_TEST")
    assert ZerocheckExtVerifier(BabyBear, _combiner, 2, 3).verify(proof, tv)
    assert tv.finalize() == digest


@pytest.mark.parametrize("device", [None, "cpu"])
def test_dispatch_by_device(device, monkeypatch):
    """ZerocheckExtProver(device=None) runs the port's native or numpy
    prover, a torch device runs GenericDeviceZerocheckExt; same bytes."""
    cols = _mk_columns(7, seed=19)
    zerocheck_dev_ext.reset_counters()
    t = FiatShamirTranscript()
    t.append_bytes(b"ZC_DEV_TEST")
    proof = ZerocheckExtProver(BabyBear, _typed(cols, Ext4), _combiner, 3, num_alphas=2, device=device).prove(t)
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == (0 if device is None else 1)
    _assert_equal(*_reference("host", cols, monkeypatch), proof, t.finalize())


def test_real_v2_combiner_matches(monkeypatch):
    """The core argument's combiner (make_v2_combiner) through the device
    prover matches zigz_tpu's numpy prover byte for byte."""
    from zigz_tpu.constraints import v2 as ref_v2
    from zigz_tpu_torch.constraints import v2 as port_v2
    from zigz_tpu_torch.constraints.core_arg import CORE_COLUMNS, V2_G_COLUMNS

    rng = np.random.default_rng(23)
    tau, beta = ([int(x) for x in rng.integers(0, P, size=4)] for _ in range(2))
    # Structural columns only: values need not satisfy the constraints
    # (both provers run the same sumcheck on the same data either way).
    v = 6
    n = 1 << v
    cols = {name: rng.integers(0, P, size=n, dtype=np.uint64) for name in (*CORE_COLUMNS, *V2_G_COLUMNS)}
    cols.update(port_v2.logup_public_tables(n, v, P))
    ref = _reference("host", cols, monkeypatch, degree=ref_v2.V2_DEGREE, num_alphas=ref_v2.NUM_V2_ALPHAS,
                     combiner=ref_v2.make_v2_combiner(ref_ext4.ext_from_ints(tau), ref_ext4.ext_from_ints(beta)))
    got = _device(cols, host_tail=8, degree=port_v2.V2_DEGREE, num_alphas=port_v2.NUM_V2_ALPHAS,
                  combiner=port_v2.make_v2_combiner(ext_from_ints(tau), ext_from_ints(beta)))
    _assert_equal(*ref, *got)


def test_lazy_reduction_stays_exact_on_long_chains():
    """compile_dag leaves sums unreduced while they fit int64: a long
    add/sub/mul chain over the extreme values 0 and p - 1 equals the exact
    integer arithmetic, and its plan launches fewer ops than one reduction
    per op would."""
    def chain(cols, alphas, p):
        acc = cols["x"]
        for k in range(40):
            acc = acc + cols["y"] - cols["x"] * 3 + alphas[0]
            if k % 8 == 7:
                acc = acc * cols["y"] % p
        return acc

    rng = np.random.default_rng(29)
    x = rng.integers(0, P, size=64, dtype=np.uint64)
    y = rng.integers(0, P, size=64, dtype=np.uint64)
    x[:4], y[:4] = [0, 0, P - 1, P - 1], [0, P - 1, 0, P - 1]
    alpha = int(rng.integers(0, P))
    trace = symtrace.trace_combiner(chain, ["x", "y"], [alpha], P)
    run = symtrace.compile_dag(trace.nodes, (trace.out,), {"x": 0, "y": 1}, trace.consts)
    planes = torch.from_numpy(np.stack([x, y]).view(np.int64))
    got = run(planes)[0].numpy()
    want = [int(chain({"x": int(a), "y": int(b)}, [alpha], P)) % P for a, b in zip(x, y)]
    assert got.tolist() == want
    ops = sum(1 for op, _a, _b in trace.nodes if op in (symtrace._ADD, symtrace._SUB, symtrace._MUL))
    assert run.num_launches < 2 * ops
