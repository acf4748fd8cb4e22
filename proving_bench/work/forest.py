"""The work of the 43-tree SHA3-256 Merkle forest (kernels K1 and K2).

From the protocol's shapes: B = 43 witness columns over N = 2^v rows.

* Permutations: B N leaf hashes (one 8-byte value each, one rate block)
  and B (N - 1) node hashes (64 bytes each, one rate block): B (2N - 1).
* Operations: the permutations x the fewest instructions one needs
  (work/keccak.py).
* Bytes: the inputs read once, B N values of 4 bytes (the witness is held
  as 32-bit words below 2^31), and the outputs written once, the 32-byte
  digest of every node of every tree, B (2N - 1) x 32: an opening reads
  the levels, so the forest keeps them.
"""

from benchlib import cell as cells

KERNELS = ("sha3_leaves_kernel", "sha3_merge_kernel")


def count(num_vars: int, columns: int = 43) -> dict:
    nodes = columns * ((2 << num_vars) - 1)
    return {"permutations": nodes,
            "instructions": nodes * cells.work("keccak").instructions(),
            "bytes": columns * (1 << num_vars) * 4 + nodes * 32}
