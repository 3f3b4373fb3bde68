"""SATD-based mode decision with fitted R-D tables.

Port of theora_tpu/encode/modedec.py (numpy, no device work), over the
port's own copy of the tables, theora_tpu_torch/modedec_tables.py.

The analyze.c mode-cost core (oc_cost_inter/intra, oc_dct_cost2,
oc_mode_scheme_chooser; analyze.c:67-205,1068-1144,1968-2287) redesigned
around our own fitted tables (theora_tpu_torch/modedec_tables.py,
regenerated by tools/collect.py rather than shipped as frozen constants
like modedec.h).

Per 8x8 block the tables give (rate bits, rmse) as a function of the
prediction-residual SATD at the frame's quantizer; a macroblock's cost for
a candidate mode is

    sum_b min(rmse_b^2 + lambda*rate_b, skip_ssd_b)
      + lambda*(mode_scheme_bits + mv_bits)

evaluated per luma block, with the mode-scheme cost tracked by an
opportunity-cost chooser over the 8 coding schemes.
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch.constants import MODE_ALPHABETS

try:
    from theora_tpu_torch import modedec_tables as _T
except ImportError:  # tables not generated
    _T = None

_VLC_BITS = (1, 2, 3, 4, 5, 6, 7, 7)


def tables_available() -> bool:
    return _T is not None


def interp_rows(dequant, qi, qti, plc=0):
    """Interpolate the (rate, rmse) anchor rows for this quantizer, like
    oc_enc_mode_rd_init (analyze.c:1068-1117). Returns (rate [NBINS],
    rmse [NBINS]) float arrays."""
    lq = float(np.log(dequant[qi, 1 if plc else 0, qti][1]))
    anchors = np.asarray(_T.LOGQ_ANCHORS)[plc, qti]
    rate = np.asarray(_T.RATE)[plc, qti]
    rmse = np.asarray(_T.RMSE)[plc, qti]
    # anchors descend; find the bracketing pair.
    i = 0
    while i < len(anchors) - 2 and anchors[i + 1] > lq:
        i += 1
    a0, a1 = anchors[i], anchors[i + 1]
    t = 0.0 if a1 == a0 else (a0 - lq) / (a0 - a1)
    return (
        rate[i] + t * (rate[i + 1] - rate[i]),
        rmse[i] + t * (rmse[i + 1] - rmse[i]),
    )


def satd_bin(satd):
    """Bin index + fractional position for a SATD value under the
    table's bin edges.

    Round-3 redesign: LOG-SPACED edges (fine at low SATD) replace the
    reference's uniform 512-wide bins (modedec.h OC_SATD_SHIFT).  With
    uniform bins, everything that matters on coherent content -- a
    perfectly predicted block (satd 0) vs a slightly mispredicted one
    (satd ~200) -- lands in bin 0 and the model cannot price motion
    against NOMV at all (measured: mode_rd collapsed to all-NOMV).
    """
    e = _T.SATD_EDGES
    b = 0
    while b < _T.NBINS - 2 and satd >= e[b + 1]:
        b += 1
    dx = (satd - e[b]) / float(e[b + 1] - e[b])
    return b, dx


def dct_cost(rate_row, rmse_row, satd):
    """Bilinear-in-SATD lookup -> (rate bits, ssd estimate) for one block
    (oc_dct_cost2 analogue; linear extrapolation past the last edge)."""
    b, dx = satd_bin(int(satd))
    r = rate_row[b] + dx * (rate_row[b + 1] - rate_row[b])
    m = rmse_row[b] + dx * (rmse_row[b + 1] - rmse_row[b])
    if r < 0.0:
        r = 0.0
    if m < 0.0:
        m = 0.0
    return r, m * m


class SchemeChooser:
    """Opportunity-cost mode-scheme tracker (analyze.c:67-205 analogue):
    the marginal bits of coding a mode = the increase of the best scheme's
    running total."""

    def __init__(self):
        self.counts = np.zeros(8, dtype=np.int64)
        self.totals = np.zeros(8, dtype=np.int64)  # scheme 0..6 VLC, 7 CLC
        # Per-scheme rank of each mode; scheme 0 re-ranks by frequency.
        self.ranks = [None] * 7
        for s in range(1, 7):
            alpha = MODE_ALPHABETS[s - 1]
            r = np.empty(8, dtype=np.int64)
            for ri in range(8):
                r[alpha[ri]] = ri
            self.ranks[s] = r
        self._rank0()

    def _rank0(self):
        order = np.argsort(-self.counts, kind="stable")
        r = np.empty(8, dtype=np.int64)
        r[order] = np.arange(8)
        self.ranks[0] = r

    def cost(self, mode: int) -> int:
        best = int(self.totals.min())
        add = np.empty(8, dtype=np.int64)
        add[0] = _VLC_BITS[self.ranks[0][mode]]
        for s in range(1, 7):
            add[s] = _VLC_BITS[self.ranks[s][mode]]
        add[7] = 3
        # Scheme 0 costs 24 bits of ranking up front.
        totals = self.totals + add
        totals0 = totals.copy()
        totals0[0] += 24 if self.counts.sum() == 0 else 0
        return int(totals.min()) - best

    def update(self, mode: int) -> None:
        add = np.empty(8, dtype=np.int64)
        add[0] = _VLC_BITS[self.ranks[0][mode]]
        for s in range(1, 7):
            add[s] = _VLC_BITS[self.ranks[s][mode]]
        add[7] = 3
        self.totals += add
        self.counts[mode] += 1
        self._rank0()
