"""The work of the Ligero commits of a v2 prove (kernels N1, N2 and K5):
one Reed-Solomon encode and one column hash of each of the DATA and
ADVICE commitments, the least the protocol needs. The openings re-encode
the committed rows, and the Merkle levels above the column digests run on
K2: neither is counted.

From the shapes the prover records, `<key>_commit_rows`, `_n` and `_n_e`
(rows of n coefficients, encoded to n_e = inv_rate x n values):

* Encode: each row is inv_rate cosets of an n-point NTT, (n_e / 2) log2 n
  butterflies, and one multiply a value for the coset shift, n_e. A
  BabyBear butterfly is a Montgomery multiply (6 integer instructions: a
  wide product, the low word times -1/p, a wide multiply-add of p, the
  high word, a compare and a select) and an add and a subtract with their
  conditional corrections (2 each): 10.
* Column hash: each of the n_e columns absorbs its rows as 4-byte words
  into SHA3-256, floor(4 rows / 136) + 1 rate blocks (the padding needs
  at least one byte), one permutation each (work/keccak.py).
* Bytes: the rows read once as 4-byte words and the n_e digests of 32
  bytes written once; a fused encode and hash needs no more.
"""

from benchlib import cell as cells

KERNELS = ("ntt_tile_kernel", "ntt_pass_kernel", "sha3_absorb_kernel")
COMMITS = ("data", "advice")
BUTTERFLY = 10
MULTIPLY = 6
RATE_BYTES = 136


def commit(rows: int, n: int, n_e: int) -> dict:
    butterflies = rows * (n_e // 2) * (n.bit_length() - 1)
    permutations = n_e * ((4 * rows) // RATE_BYTES + 1)
    return {"butterflies": butterflies, "permutations": permutations,
            "instructions": (butterflies * BUTTERFLY + rows * n_e * MULTIPLY
                             + permutations * cells.work("keccak").instructions()),
            "bytes": rows * n * 4 + n_e * 32}


def count(timings: dict):
    """The work of one prove's two commits, from its `last_timings`; None
    where the prover does not record the shapes."""
    keys = [f"{c}_commit_{k}" for c in COMMITS for k in ("rows", "n", "n_e")]
    if not all(k in timings for k in keys):
        return None
    works = [commit(*(int(timings[f"{c}_commit_{k}"]) for k in ("rows", "n", "n_e"))) for c in COMMITS]
    return {k: sum(w[k] for w in works) for k in works[0]}
