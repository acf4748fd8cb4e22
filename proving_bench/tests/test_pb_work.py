"""The work counts at small shapes, against counts made by hand."""

from pb_support import cell


def test_keccak_instructions_by_hand():
    k = cell.work("keccak")
    # Round constants with both 32-bit halves non-zero, rounds 2-24.
    both = sum(1 for rc in k.RC[1:] if rc >> 32 and rc & 0xFFFFFFFF)
    one = len(k.RC[1:]) - both
    assert k.FULL_ROUND == 178 and k.LAST_ROUND == 56
    assert k.instructions() == 22 * 178 + 56 + 2 * both + one == 4008


def test_forest_at_two_variables():
    # 43 trees of 4 leaves: 4 leaf hashes and 3 node hashes each.
    w = cell.work("forest").count(2)
    assert w["permutations"] == 43 * 7
    assert w["instructions"] == 43 * 7 * 4008
    assert w["bytes"] == 43 * 4 * 4 + 43 * 7 * 32
