"""Inputs of the CAVLC residual coder's tests (tests/test_torch_cavlc.py)
and of chip_smoke.py's check of the kernel (csrc/cavlc.cu) on the card:
blocks of zig-zag levels, made with numpy from fixed seeds, that reach
every branch of residual_blocks_dev.

`cavlc_cases()` returns {name: (coeffs [B, L] int32, nc [B] int32,
chroma_dc)}:
- each nC class of the 16-coefficient luma block (0-1, 2-3, 4-7, 8 and
  up), the 15-coefficient AC block, the 2x2 and 2x4 chroma DC blocks;
- all-zero and full blocks (total == L);
- three trailing ones, and trailing ones broken by |level| > 1 after one
  or two of them;
- the suffix length stepping from 0 up to 6, from a first level coded at
  suffix length 0 and from one at 1 (more than 10 coefficients and fewer
  than three trailing ones);
- levels at and past the escape limit (30 + 4095 at suffix length 0,
  (15 << sl) + 4095 above it), so that `over` is set;
- wide random levels and, with `big`, a 1080p frame's luma batch (8,160
  MBs x 16 blocks = 130,560) of small, sparse levels.
"""

import numpy as np

LUMA_1080P_BLOCKS = 8160 * 16


def _signs(rng, shape):
    return rng.choice(np.array([-1, 1]), shape)


def _sparse(rng, B, L, scale):
    """B blocks of L levels: each block's density drawn from [0, 1], the
    magnitudes geometric with mean ~1 / scale."""
    density = rng.random((B, 1))
    keep = rng.random((B, L)) < density
    mag = rng.geometric(scale, (B, L))
    return (keep * mag * _signs(rng, (B, L))).astype(np.int32)


def _nc(rng, B, lo, hi):
    return rng.integers(lo, hi + 1, B).astype(np.int32)


def _place(rows, L, rng):
    """Blocks of L levels whose nonzeros, from the last, are each row of
    `rows`, at random positions in increasing order."""
    out = np.zeros((len(rows), L), np.int32)
    for b, rev in enumerate(rows):
        pos = np.sort(rng.choice(L, len(rev), replace=False))
        out[b, pos] = rev[::-1]
    return out


def _trailing_ones(rng):
    rows = []
    for _ in range(64):
        t1 = int(rng.integers(0, 4))
        head = list(_signs(rng, t1))
        if t1 < 3:                      # broken by |level| > 1
            head.append(int(rng.integers(2, 9)) * int(_signs(rng, 1)[0]))
        tail_n = int(rng.integers(0, 16 - len(head) + 1))
        tail = list(rng.integers(1, 4, tail_n) * _signs(rng, tail_n))
        rows.append(np.array(head + tail, np.int32))
    # one or two +-1, then a level > 1, then +-1 again (not trailing)
    rows += [np.array([1, -3, 1, -1], np.int32),
             np.array([-1, 1, 2, 1, 1], np.int32),
             np.array([1, 1, 1, 1, 1, 1], np.int32),
             np.array([-1] * 16, np.int32), np.array([2], np.int32),
             np.array([1], np.int32), np.array([-1, -1], np.int32)]
    return _place(rows, 16, rng)


def _suffix_steps(rng):
    # from the last: levels that cross 3 << (sl - 1) at each step, so that
    # the suffix length climbs 0 -> 1 -> ... -> 6 and stays
    climb = [2, 5, 7, 13, 25, 49, 97, 200, 3, 1, 400]
    rows = []
    for _ in range(32):
        n = int(rng.integers(3, len(climb) + 1))
        rev = np.array(climb[:n]) * _signs(rng, n)
        t1 = int(rng.integers(0, 3))
        rows.append(np.concatenate([_signs(rng, t1), rev]).astype(np.int32))
    # more than 10 coefficients and fewer than three trailing ones: the
    # first level codes at suffix length 1
    for _ in range(32):
        n = int(rng.integers(11, 17))
        t1 = int(rng.integers(0, 3))
        rev = rng.integers(2, 60, n - t1) * _signs(rng, n - t1)
        rows.append(np.concatenate([_signs(rng, t1), rev]).astype(np.int32))
    return _place(rows, 16, rng)


def _escape(rng):
    # levels around each suffix length's limit: |lc| near 30 + 4095 (sl 0)
    # and (15 << sl) + 4095, lc = 2 |level| - 2 (- 1 if negative), 2 less
    # for the first level after fewer than three trailing ones
    probe = [2061, 2062, 2063, 2064, 2065, 2066, 2078, 2079, 2080, 2093,
             2094, 2095, 2125, 2126, 2127, 2189, 2190, 2191, 2318, 2319,
             2320, 2527, 2528, 2529, 2530, 5000, 40000]
    rows = []
    for v in probe:
        for sign in (1, -1):
            for sl in range(7):
                # sl levels that raise the suffix length to sl first
                lead = [200] * sl
                for t1 in (0, 2, 3):
                    rev = list(_signs(rng, t1)) + lead + [sign * v]
                    if len(rev) <= 16:
                        rows.append(np.array(rev, np.int32))
    return _place(rows, 16, rng)


def _zero_full(rng, B, L):
    half = B // 2
    full = rng.integers(1, 12, (B - half, L)) * _signs(rng, (B - half, L))
    ones = rng.random((B - half, L)) < 0.3
    full = np.where(ones, _signs(rng, (B - half, L)), full)
    return np.concatenate([np.zeros((half, L), np.int64), full]) \
        .astype(np.int32)


def cavlc_cases(big=False):
    """{name: (coeffs [B, L] int32, nc [B] int32, chroma_dc)}; with big,
    also the 1080p luma batch."""
    rng = np.random.default_rng(16)
    cases = {}
    for name, lo, hi in (("l16_nc0_1", 0, 1), ("l16_nc2_3", 2, 3),
                         ("l16_nc4_7", 4, 7), ("l16_nc8_up", 8, 64)):
        cases[name] = (_sparse(rng, 600, 16, 0.5), _nc(rng, 600, lo, hi),
                       False)
    cases["l15_ac"] = (_sparse(rng, 600, 15, 0.5), _nc(rng, 600, 0, 16),
                       False)
    cases["chroma_dc_2x2"] = (_sparse(rng, 400, 4, 0.4),
                              np.zeros(400, np.int32), True)
    cases["chroma_dc_2x4"] = (_sparse(rng, 400, 8, 0.4),
                              np.zeros(400, np.int32), True)
    cases["zero_full_l16"] = (_zero_full(rng, 300, 16), _nc(rng, 300, 0, 16),
                              False)
    cases["zero_full_l15"] = (_zero_full(rng, 300, 15), _nc(rng, 300, 0, 16),
                              False)
    cases["zero_full_2x2"] = (_zero_full(rng, 100, 4),
                              np.zeros(100, np.int32), True)
    cases["zero_full_2x4"] = (_zero_full(rng, 100, 8),
                              np.zeros(100, np.int32), True)
    tones = _trailing_ones(rng)
    cases["trailing_ones"] = (tones, _nc(rng, len(tones), 0, 16), False)
    steps = _suffix_steps(rng)
    cases["suffix_steps"] = (steps, _nc(rng, len(steps), 0, 16), False)
    esc = _escape(rng)
    cases["escape_over"] = (esc, _nc(rng, len(esc), 0, 16), False)
    cases["escape_over_l15"] = (np.ascontiguousarray(esc[:, 1:]),
                                _nc(rng, len(esc), 0, 16), False)
    wide = (rng.integers(-5000, 5001, (1000, 16))
            * (rng.random((1000, 16)) < rng.random((1000, 1))))
    cases["wide_random"] = (wide.astype(np.int32), _nc(rng, 1000, 0, 20),
                            False)
    if big:
        cases["luma_1080p"] = (_sparse(rng, LUMA_1080P_BLOCKS, 16, 0.6),
                               _nc(rng, LUMA_1080P_BLOCKS, 0, 16), False)
    return cases
