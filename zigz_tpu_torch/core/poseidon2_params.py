"""Grain-LFSR parameter generation for Poseidon/Poseidon2 (standard
procedure, offline-reproducible).

The reference pins hash-zig v2.0.0 for Poseidon2 (build.zig.zon:8-11,
intent at src/core/hash.zig:47-49) but never completes the integration.
Round-2/3 of this build shipped a self-derived SHA3-seeded constant set;
this module replaces it with constants produced by THE published
generation procedure — the 80-bit Grain LFSR of the Poseidon reference
implementation (`generate_parameters_grain.sage`, Grassi-Khovratovich-
Rechberger-Roy-Schofnegger, also used verbatim by the Poseidon2 reference
implementation's `poseidon2_rust_params.sage`):

* state: 80 bits initialized from the parameter description
  (2-bit field tag | 4-bit s-box tag | 12-bit field size n | 12-bit t |
  10-bit R_F | 10-bit R_P | 30 ones), each field big-endian;
* update: b_{i+80} = b_{i+62} ^ b_{i+51} ^ b_{i+38} ^ b_{i+23}
  ^ b_{i+13} ^ b_i, with 160 initial outputs discarded;
* self-shrinking output: consume bit pairs (x, y), emit y iff x = 1;
* prime-field constants: n bits big-endian, rejection-sampled to < p.

The LFSR implementation is validated against the publicly documented
first BN254 Poseidon constant for (n=254, t=3, R_F=8, R_P=57)
(tests/test_poseidon2.py) — the classic cross-implementation KAT — so
the BabyBear stream below is the standard one by construction.

Offline caveat, stated plainly: this environment has no network access,
so the literal Plonky3/HorizenLabs BabyBear tables could not be vendored
for a direct diff.  What is standard here is the CONSTANT STREAM (Grain
over the documented parameter encoding); the partitioning into external/
internal constants follows the Poseidon2 paper (t-wide constants for the
R_F external rounds, one constant per internal round, consumed in round
order), and the internal diagonal is drawn from the continuation of the
same stream (distinct, nonzero, and I + diag(mu) invertible enforced by
construction).  To adopt a vendored table set verbatim, paste it over
`babybear_t16_constants()`'s return value — the permutation code
(core/poseidon2.py) is table-agnostic.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = [
    "GrainLFSR",
    "grain_field_constants",
    "babybear_t16_constants",
    "internal_matrix_security_report",
]


class GrainLFSR:
    """The Poseidon reference implementation's parameter-derivation LFSR."""

    def __init__(self, field_tag: int, sbox_tag: int, n: int, t: int,
                 r_f: int, r_p: int):
        bits: List[int] = []

        def push(value: int, width: int):
            for i in range(width - 1, -1, -1):
                bits.append((value >> i) & 1)

        push(field_tag, 2)
        push(sbox_tag, 4)
        push(n, 12)
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        # Warm-up: 160 update rounds, outputs discarded.
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def next_bit(self) -> int:
        """Self-shrinking: emit y of the next (x, y) pair with x = 1."""
        while True:
            x = self._next_raw()
            y = self._next_raw()
            if x == 1:
                return y

    def next_field_element(self, n_bits: int, p: int) -> int:
        """n_bits big-endian, rejection-sampled into [0, p)."""
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self.next_bit()
            if v < p:
                return v


def grain_field_constants(p: int, n_bits: int, t: int, r_f: int, r_p: int,
                          count: int) -> List[int]:
    """First ``count`` prime-field constants of the Grain stream for the
    given Poseidon parameter description (field tag 1, s-box tag 0 =
    x^alpha — the tags used for every prime-field alpha instance)."""
    g = GrainLFSR(1, 0, n_bits, t, r_f, r_p)
    return [g.next_field_element(n_bits, p) for _ in range(count)]


def babybear_t16_constants() -> Tuple[List[List[int]], List[int], List[int]]:
    """(external_rcs [R_F][16], internal_rcs [R_P], internal_diag [16])
    for Poseidon2 over BabyBear, t=16, alpha=7, R_F=8, R_P=13.

    One Grain stream (n=31 bits) in round order: 4 initial external
    t-vectors, R_P internal singles, 4 final external t-vectors, then the
    internal diagonal (resampled while zero / colliding / singular)."""
    p = 2013265921
    t, r_f, r_p = 16, 8, 13
    g = GrainLFSR(1, 0, 31, t, r_f, r_p)

    def take(k: int) -> List[int]:
        return [g.next_field_element(31, p) for _ in range(k)]

    ext: List[List[int]] = [take(t) for _ in range(r_f // 2)]
    internal = take(r_p)
    ext += [take(t) for _ in range(r_f // 2)]

    # Internal diagonal mu: I + diag(mu) must be invertible (mu_i != -1)
    # and the entries distinct and nonzero; the Poseidon2 paper's
    # invariant-subspace condition on the resulting internal matrix
    # M_I = J + diag(mu) is verified by
    # :func:`internal_matrix_security_report` (round-5 advisor fix:
    # structural conditions alone do not establish the security margin —
    # the verified property is that char(M_I) is irreducible over F_p,
    # the sufficient condition of Grassi-Rechberger-Schofnegger "Proving
    # Resistance Against Infinitely Long Subspace Trails", which rules
    # out every nontrivial M_I-invariant subspace; checked in
    # tests/test_poseidon2.py against the shipped instance).
    diag: List[int] = []
    seen = set()
    while len(diag) < t:
        v = g.next_field_element(31, p)
        if v == 0 or v == p - 1 or v in seen:
            continue
        seen.add(v)
        diag.append(v)
    return ext, internal, diag


# ---------------------------------------------------------------------------
# Internal-matrix security verification (round 5, advisor finding).
#
# The Poseidon2 paper requires the internal matrix to have no nontrivial
# invariant subspaces (else infinitely long subspace trails exist through
# the partial rounds, Grassi-Rechberger-Schofnegger ToSC 2020).  A
# sufficient condition their tooling checks: the characteristic polynomial
# of M_I over F_p is IRREDUCIBLE of degree t — then the minimal polynomial
# equals it, and any invariant subspace would correspond to a proper
# factor, so only {0} and F_p^t are invariant.  We verify exactly that for
# the shipped matrix, extracted from the permutation code itself.
# ---------------------------------------------------------------------------


def _char_poly_mod(M: List[List[int]], p: int) -> List[int]:
    """Characteristic polynomial of t x t matrix M over F_p via
    Faddeev-LeVerrier: returns [1, c1, ..., ct] (big-endian, monic)."""
    t = len(M)

    def matmul(A, B):
        return [[sum(A[i][k] * B[k][j] for k in range(t)) % p
                 for j in range(t)] for i in range(t)]

    def trace(A):
        return sum(A[i][i] for i in range(t)) % p

    Mk = [row[:] for row in M]
    cs = [(-trace(Mk)) % p]
    for k in range(2, t + 1):
        Madd = [[(Mk[i][j] + (cs[-1] if i == j else 0)) % p
                 for j in range(t)] for i in range(t)]
        Mk = matmul(M, Madd)
        cs.append((-trace(Mk) * pow(k, p - 2, p)) % p)
    return [1] + cs


def _poly_irreducible_mod(f_be: List[int], p: int) -> bool:
    """Irreducibility of a monic degree-t polynomial over F_p with t a
    prime power 2^k: x^(p^t) == x (mod f) and gcd(x^(p^(t/2)) - x, f) = 1
    (all factor degrees divide t; none divide t/2 => all equal t)."""
    t = len(f_be) - 1
    mod = f_be[::-1]  # little-endian, mod[t] == 1

    def mulmod(a, b):
        r = [0] * (2 * t - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    r[i + j] = (r[i + j] + ai * bj) % p
        for i in range(2 * t - 2, t - 1, -1):
            c = r[i]
            if c:
                r[i] = 0
                for j in range(t):
                    r[i - t + j] = (r[i - t + j] - c * mod[j]) % p
        return r[:t]

    def pow_x(e: int):
        result = [0] * t
        result[0] = 1
        base = [0] * t
        base[1] = 1
        while e:
            if e & 1:
                result = mulmod(result, base)
            base = mulmod(base, base)
            e >>= 1
        return result

    def deg(a):
        for i in range(len(a) - 1, -1, -1):
            if a[i]:
                return i
        return -1

    def gcd(a, b):
        a, b = a[:], b[:]
        while deg(b) >= 0:
            if deg(a) < deg(b):
                a, b = b, a
                continue
            inv = pow(b[deg(b)], p - 2, p)
            while deg(a) >= deg(b) >= 0:
                sh = deg(a) - deg(b)
                c = a[deg(a)] * inv % p
                for i in range(deg(b) + 1):
                    a[i + sh] = (a[i + sh] - c * b[i]) % p
            a, b = b, a
        return a

    x = [0] * t
    x[1] = 1
    xt = pow_x(pow(p, t))
    if any((xt[i] - x[i]) % p for i in range(t)):
        return False
    xh = pow_x(pow(p, t // 2))
    d = [(xh[i] - x[i]) % p for i in range(t)]
    g = gcd(d, mod[:t] + [1])
    return deg(g) == 0


def internal_matrix_security_report(p: int = 2013265921) -> dict:
    """Verify the shipped Poseidon2 internal matrix (extracted from the
    permutation implementation, not re-derived from the tables):
    invertibility + irreducible characteristic polynomial => no
    nontrivial invariant subspaces (infinitely-long-subspace-trail
    resistance).  Result is asserted by tests/test_poseidon2.py."""
    from . import poseidon2 as p2

    t = p2.T
    M = []
    for j in range(t):
        e = [0] * t
        e[j] = 1
        col = p2._internal_linear(e)
        M.append(col)
    # M currently holds images of basis vectors as rows; transpose to the
    # conventional M[i][j] = (M e_j)_i.
    M = [[M[j][i] % p for j in range(t)] for i in range(t)]
    f = _char_poly_mod(M, p)
    det_nonzero = f[-1] != 0
    irreducible = _poly_irreducible_mod(f, p)
    return {
        "t": t,
        "invertible": det_nonzero,
        "char_poly_irreducible": irreducible,
        "no_invariant_subspaces": det_nonzero and irreducible,
        "char_poly": f,
    }
