"""SHA3-256 hashing + the Fiat-Shamir transcript (consensus-critical).

Reference: zigz src/core/hash.zig.  Every byte absorbed here is
part of the proof-bytes contract, so this module is an exact twin:

* field elements absorb as the 8-byte little-endian canonical u64 limb
  (hash.zig:279-283 via ``std.mem.toBytes`` on T=u64);
* ``challenge()`` clones the streaming hasher, finalizes the clone, derives
  the field element from the first ``min(T_bits/8, 32)`` digest bytes
  (little-endian, reduced mod p — hash.zig:228-242), and then re-absorbs the
  full 32-byte digest into the live transcript so successive challenges
  differ (hash.zig:301-316, the critical re-absorb at :313);
* Merkle leaves hash the same 8-byte LE encoding (hash.zig:135-147), nodes
  hash left||right (hash.zig:187-195).

Python's ``hashlib.sha3_256`` is NIST SHA3 (same as Zig's
``std.crypto.hash.sha3.Sha3_256``); ``.copy()`` replicates the Zig
clone-then-final pattern.
"""

from __future__ import annotations

import hashlib

__all__ = [
    "Digest",
    "hash_field_element",
    "hash_field_elements",
    "merge_hashes",
    "hash_bytes",
    "digest_to_field_element",
    "FiatShamirTranscript",
    "SHA3Hasher",
    "sha256",
]

Digest = bytes  # 32 bytes


def sha256(data: bytes) -> bytes:
    """SHA-256 (program-hash binding uses SHA2, prover.zig:98-100)."""
    return hashlib.sha256(data).digest()


def hash_field_element(F, element) -> Digest:
    """SHA3-256 over the canonical 8-byte LE limb (hash.zig:135-147)."""
    return hashlib.sha3_256(element.to_bytes()).digest()


def hash_field_element_value(value: int, nbytes: int = 8) -> Digest:
    """Same as :func:`hash_field_element` but from a canonical int value."""
    return hashlib.sha3_256(value.to_bytes(nbytes, "little")).digest()


def hash_field_elements(F, elements) -> Digest:
    """hash.zig:162-176 — stream all canonical limbs through one SHA3."""
    h = hashlib.sha3_256()
    for el in elements:
        h.update(el.to_bytes())
    return h.digest()


def merge_hashes(left: Digest, right: Digest) -> Digest:
    """Merkle node combiner: SHA3(left || right) (hash.zig:187-195)."""
    h = hashlib.sha3_256()
    h.update(left)
    h.update(right)
    return h.digest()


def hash_bytes(data: bytes) -> Digest:
    """hash.zig:215-222."""
    return hashlib.sha3_256(data).digest()


def digest_to_field_element(F, digest: Digest):
    """Interpret the first min(T_bits/8, 32) digest bytes LE, reduce mod p.

    hash.zig:228-242.  All presets use T=u64 → 8 bytes.
    """
    num_bytes = min(F.BITS // 8, len(digest))
    value = int.from_bytes(digest[:num_bytes], "little")
    return F(value)


class FiatShamirTranscript:
    """Streaming SHA3-256 Fiat-Shamir transcript (hash.zig:255-324)."""

    __slots__ = ("_hasher",)

    def __init__(self):
        self._hasher = hashlib.sha3_256()

    def append_field_element(self, F, element) -> None:
        self._hasher.update(element.to_bytes())

    def append_field_elements(self, F, elements) -> None:
        for el in elements:
            self._hasher.update(el.to_bytes())

    def append_u64(self, value: int) -> None:
        """Absorb a raw canonical value as 8 LE bytes (same wire format as
        ``append_field_element`` after ``F.init``); callers must pre-reduce."""
        self._hasher.update(int(value).to_bytes(8, "little"))

    def append_bytes(self, data: bytes) -> None:
        self._hasher.update(data if isinstance(data, bytes) else bytes(data, "ascii"))

    def append_u64s(self, values) -> None:
        """Absorb an array of canonical u64s as one LE blob — byte-
        identical to repeated ``append_u64`` calls (the transcript is a
        raw streaming absorber with no per-append framing)."""
        import numpy as np

        self._hasher.update(np.ascontiguousarray(values, dtype="<u8").tobytes())

    def fork(self) -> "FiatShamirTranscript":
        """Independent copy sharing the absorbed prefix — used by the
        prover to TRIAL challenge derivations (e.g. the logUp nonce search)
        without mutating the live transcript."""
        t = FiatShamirTranscript()
        t._hasher = self._hasher.copy()
        return t

    def challenge(self, F):
        """Clone-final-reabsorb challenge derivation (hash.zig:301-316)."""
        digest = self._hasher.copy().digest()
        result = digest_to_field_element(F, digest)
        # CRITICAL: re-absorb the digest so successive challenges differ.
        self._hasher.update(digest)
        return result

    def challenge_value(self, modulus: int) -> int:
        """challenge() returning the raw canonical int (hot-path variant)."""
        digest = self._hasher.copy().digest()
        value = int.from_bytes(digest[:8], "little") % modulus
        self._hasher.update(digest)
        return value

    def challenge_index(self, n: int) -> int:
        """Uniform draw from [0, n) for POWER-OF-TWO n: the low log2(n)
        bits of a uniform u64 are exactly uniform (n divides 2^64).  Used
        for Ligero query-column sampling, where the previous
        (u64 % p) % n derivation carried a ~n/p modulo bias (advisor
        finding, round 3)."""
        assert n > 0 and n & (n - 1) == 0, "challenge_index needs a power of two"
        digest = self._hasher.copy().digest()
        value = int.from_bytes(digest[:8], "little") & (n - 1)
        self._hasher.update(digest)
        return value

    def finalize(self) -> Digest:
        return self._hasher.digest()


class SHA3Hasher:
    """GenericHasher(.SHA3_256) twin (hash.zig:518-544)."""

    name = "SHA3-256"

    @staticmethod
    def hash_leaf(F, value) -> Digest:
        return hash_field_element(F, value)

    @staticmethod
    def hash_leaf_value(value: int) -> Digest:
        return hash_field_element_value(value)

    @staticmethod
    def hash_internal(left: Digest, right: Digest) -> Digest:
        return merge_hashes(left, right)
