"""Binary SHA3-256 Merkle trees over field-element leaves.

Reference: zigz src/commitments/merkle_tree.zig (the working
``SimpleMerkleTree``, :273-403).  Wire-exact rules:

* leaf hash  = SHA3-256(little-endian 8-byte canonical value)
  (merkle_tree.zig:246-252 via hash.zig:135-147);
* node hash  = SHA3-256(left || right) (merkle_tree.zig:255-262);
* leaves are zero-padded to the next power of two with SHA3(F.zero())
  (merkle_tree.zig:302-307);
* ``open(index)`` records sibling digests bottom-up plus is-right flags
  (merkle_tree.zig:324-360); ``verify`` walks the path from the leaf hash
  (merkle_tree.zig:362-373).

Unlike the reference (which re-folds the whole tree per opening), we retain
every level from ``build`` so openings are O(log n) — the produced bytes are
identical.  Leaf hashing is delegated to a pluggable batch hasher so the
C++/threaded backend can accelerate it (see zigz_tpu.runtime).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import List

import numpy as np

from ..core.hash import SHA3Hasher

__all__ = ["MerklePath", "OpeningProof", "SimpleMerkleTree", "batch_leaf_hashes", "batch_merge_hashes"]


def _ceil_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# Batch hashing backends.  The default is a tight hashlib loop; the native
# runtime (zigz_tpu/runtime/sha3.cpp) replaces these at import time when the
# shared library is available.
# ---------------------------------------------------------------------------

def _py_batch_leaf_hashes(values: np.ndarray) -> bytes:
    """SHA3-256 of each 8-byte LE value; returns concatenated digests."""
    sha3 = hashlib.sha3_256
    le = np.ascontiguousarray(values, dtype="<u8").tobytes()
    out = bytearray(len(values) * 32)
    for i in range(len(values)):
        out[i * 32 : (i + 1) * 32] = sha3(le[i * 8 : (i + 1) * 8]).digest()
    return bytes(out)


def _py_batch_merge_hashes(level: bytes) -> bytes:
    """Hash adjacent 32-byte digest pairs; len(level) % 64 == 0."""
    sha3 = hashlib.sha3_256
    n = len(level) // 64
    out = bytearray(n * 32)
    for i in range(n):
        out[i * 32 : (i + 1) * 32] = sha3(level[i * 64 : (i + 1) * 64]).digest()
    return bytes(out)


def _py_batch_build_levels(leaf_bytes: bytes) -> List[bytes]:
    """All internal levels from the padded leaf-digest blob."""
    levels = [leaf_bytes]
    cur = leaf_bytes
    while len(cur) > 32:
        cur = batch_merge_hashes(cur)
        levels.append(cur)
    return levels


batch_leaf_hashes = _py_batch_leaf_hashes
batch_merge_hashes = _py_batch_merge_hashes
batch_build_levels = _py_batch_build_levels


def set_hash_backend(leaf_fn, merge_fn, levels_fn=None) -> None:
    """Install an accelerated (bit-identical) hashing backend."""
    global batch_leaf_hashes, batch_merge_hashes, batch_build_levels
    batch_leaf_hashes = leaf_fn
    batch_merge_hashes = merge_fn
    batch_build_levels = levels_fn if levels_fn is not None else _py_batch_build_levels


@dataclass
class MerklePath:
    siblings: List[bytes] = dc_field(default_factory=list)
    directions: List[bool] = dc_field(default_factory=list)  # True = leaf is right child


@dataclass
class OpeningProof:
    index: int
    value: object  # field element
    path: MerklePath


def _hash_fns(hash_mode: str):
    """(batch_leaf, batch_merge, scalar_hasher_class) for a mode."""
    if hash_mode != "sha3":
        raise NotImplementedError(f"hash mode {hash_mode!r} is not ported (sha3 only)")
    return batch_leaf_hashes, batch_merge_hashes, SHA3Hasher


def hasher_for_mode(hash_mode: str):
    return _hash_fns(hash_mode)[2]


class SimpleMerkleTree:
    """values: unpadded canonical uint64 array; levels[0] = padded leaf hashes."""

    __slots__ = ("F", "values", "levels", "height", "hash_mode")

    def __init__(self, F, values, levels, height, hash_mode="sha3"):
        self.F = F
        self.values = values
        self.levels = levels
        self.height = height
        self.hash_mode = hash_mode

    @classmethod
    def build(cls, F, values, hash_mode: str = "sha3") -> "SimpleMerkleTree":
        if isinstance(values, np.ndarray):
            vals = np.ascontiguousarray(values, dtype=np.uint64)
        else:
            if len(values) == 0:
                raise ValueError("EmptyValues")
            vals = np.array(
                [v.value if hasattr(v, "value") else int(v) % F.MODULUS for v in values],
                dtype=np.uint64,
            )
        n = len(vals)
        if n == 0:
            raise ValueError("EmptyValues")
        padded = _ceil_pow2(n)
        height = padded.bit_length() - 1

        leaf_fn, merge_fn, scalar = _hash_fns(hash_mode)
        leaf_bytes = leaf_fn(vals)
        if padded > n:
            zero_hash = scalar.hash_leaf_value(0)
            leaf_bytes = leaf_bytes + zero_hash * (padded - n)
        if hash_mode == "sha3":
            levels = batch_build_levels(leaf_bytes)
        else:
            levels = [leaf_bytes]
            cur = leaf_bytes
            while len(cur) > 32:
                cur = merge_fn(cur)
                levels.append(cur)
        return cls(F, vals, levels, height, hash_mode)

    def get_root(self) -> bytes:
        return self.levels[-1]

    root = property(get_root)

    def open(self, index: int) -> OpeningProof:
        """Sibling path for an unpadded leaf (merkle_tree.zig:324-360)."""
        if index >= len(self.values):
            raise IndexError("IndexOutOfBounds")
        path = MerklePath()
        cur = index
        for level in range(self.height):
            is_right = (cur % 2) == 1
            sibling_index = cur - 1 if is_right else cur + 1
            lvl = self.levels[level]
            path.siblings.append(lvl[sibling_index * 32 : sibling_index * 32 + 32])
            path.directions.append(is_right)
            cur //= 2
        return OpeningProof(
            index=index,
            value=self.F.from_reduced(int(self.values[index])),
            path=path,
        )

    @staticmethod
    def verify(F, root: bytes, proof: OpeningProof, hasher=SHA3Hasher) -> bool:
        """Walk the path from the claimed leaf value (merkle_tree.zig:362-373)."""
        current = hasher.hash_leaf(F, proof.value)
        for sibling, is_right in zip(proof.path.siblings, proof.path.directions):
            if is_right:
                current = hasher.hash_internal(sibling, current)
            else:
                current = hasher.hash_internal(current, sibling)
        return current == root

    @staticmethod
    def verify_at_index(F, root: bytes, proof: OpeningProof, height: int,
                        hasher=SHA3Hasher) -> bool:
        """Strict variant for the v2+ paths: the direction bits are DERIVED
        from ``proof.index`` and the path must be exactly ``height`` levels,
        so the proof-supplied directions list cannot authenticate a
        different leaf at arbitrary depth (the v1 ``verify`` must keep the
        reference's trusting semantics for wire parity)."""
        if len(proof.path.siblings) != height:
            return False
        if not 0 <= proof.index < (1 << height):
            return False
        current = hasher.hash_leaf(F, proof.value)
        idx = proof.index
        for sibling in proof.path.siblings:
            if idx & 1:
                current = hasher.hash_internal(sibling, current)
            else:
                current = hasher.hash_internal(current, sibling)
            idx >>= 1
        return current == root
