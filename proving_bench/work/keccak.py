"""The fewest 32-bit integer instructions one Keccak-f[1600] permutation
needs on sm_90, where it produces a SHA3-256 digest.

A 64-bit lane is two 32-bit words. A round, with `LOP3` (any function of
three inputs, one instruction a word) and `SHF` funnel shifts (a 64-bit
rotate by any amount but 0 or 32 is two of them):

* theta, the column parities: five lanes XORed, two `LOP3` a word:
  5 columns x 2 words x 2 = 20;
* theta, each parity rotated by 1: 5 x 2 `SHF` = 10;
* theta applied, each lane XORed with two parities in one `LOP3` a word:
  25 x 2 = 50;
* rho: 24 lanes rotated (no offset is 0 or 32 but lane (0, 0)'s):
  24 x 2 = 48; pi moves registers and costs nothing;
* chi, a ^ (~b & c), one `LOP3` a word: 25 x 2 = 50;
* iota: one XOR a non-zero word of the round constant.

A full round is 178 plus iota. Two rounds are cheaper, and counting them in
full would overstate the least work:

* round 1 is not counted at all: most of its input lanes are constants
  (the padding, and zeros past the message), which a compiler folds;
* round 24 needs only the four lanes of the digest: their chi (4 x 2), the
  rho of the five lanes of row 0 that feed it (4 x 2; lane (0, 0) is not
  rotated), theta applied to those five (5 x 2) and all the parities
  (20 + 10): 56, plus iota.

Loads, stores and moves are not integer instructions and are not counted.
"""

RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
FULL_ROUND = 20 + 10 + 50 + 48 + 50
LAST_ROUND = 8 + 8 + 10 + 20 + 10


def _iota(rc: int) -> int:
    return (rc & 0xFFFFFFFF != 0) + (rc >> 32 != 0)


def instructions() -> int:
    """One permutation: rounds 2-23 in full, round 24 for the digest."""
    return 22 * FULL_ROUND + LAST_ROUND + sum(_iota(rc) for rc in RC[1:])
