"""Exact-order in-loop deblocking filter over a whole plane.

Port of theora_tpu/ops/loopfilter_jax.py (`loop_filter_plane_jax`): the
same three globally vectorized phases (P1 interior horizontal filters, B
bottom-edge chains, A top-edge chains) that reproduce the VP3 raster edge
order (state.c:1055-1105); its docstring carries the derivation. The
bounding-value table (state.c:1036-1045) is evaluated in closed form from
the filter limit, as the JAX version does.

Updates follow the JAX code's functional form: `_set` writes into a
fresh copy, so every earlier read keeps the snapshot it had.
"""
from __future__ import annotations

import torch


def _resp(f, limit: int):
    r = (f + 4) >> 3
    a = r.abs()
    return torch.sign(r) * torch.clamp(torch.minimum(a, 2 * limit - a), min=0)


def _f4(p0, p1, p2, p3):
    return p0 - p3 + 3 * (p2 - p1)


def _clamp(x):
    return torch.clamp(x, 0, 255)


def _shift_right(v):
    """Shift [nv, nh] by one block column with zero fill."""
    return torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)


def _set(x, idx, value):
    y = x.clone()
    y[idx] = value
    return y


def loop_filter_plane(plane, coded, limit: int, nv: int, nh: int,
                      pad_y: int, pad_x: int):
    """plane: [Hp, Wp] uint8; coded: [nv, nh] bool; limit: the frame's
    loop-filter limit (> 0). Returns the filtered plane (uint8)."""
    W = plane.shape[1]
    Wb = W // 8
    pb = pad_x // 8
    lo = pb - 1
    cols0 = slice(pb, pb + nh)      # block columns c
    colsm1 = slice(lo, lo + nh)     # block columns c-1
    c8 = torch.arange(8, device=plane.device)

    def m0(V, k):
        return V[..., cols0, k]

    def mm1(V, k):
        return V[..., colsm1, k]

    def setk(V, cols, k, new):
        return _set(V, (Ellipsis, cols, k), new)

    I = plane.to(torch.int32, copy=True)
    # Blocked interior: R[r, k, c, j] = pixel (pad_y + 8r + k, 8c + j).
    R = I[pad_y:pad_y + 8 * nv].reshape(nv, 8, Wb, 8).clone()
    orig = R                                        # pre-filter snapshot
    top2 = I[pad_y - 2].reshape(Wb, 8)              # y0-2 of row 0
    top1 = I[pad_y - 1].reshape(Wb, 8)              # y0-1 of row 0
    bot0 = I[pad_y + 8 * nv].reshape(Wb, 8)         # y0+8 of last row
    bot1 = I[pad_y + 8 * nv + 1].reshape(Wb, 8)     # y0+9 of last row

    c = coded
    zcol = torch.zeros((nv, 1), dtype=torch.bool, device=c.device)
    hfire = torch.cat([zcol, c[:, 1:] | c[:, :-1]], dim=1)
    left_fired = torch.cat([zcol, c[:, 1:]], dim=1)
    below = torch.cat([c[1:], torch.zeros_like(c[:1])])
    rows = torch.arange(nv, device=c.device)[:, None]
    vL = c & (rows != 0)
    vE = c & ~below & (rows != nv - 1)
    nxt_coded = torch.cat([c[:, 1:], zcol], dim=1)

    # ---- Phase P1: h filters, rows y0+1..y0+6, all fragment rows -----
    R16 = R[:, 1:7]
    p0, p1, p2, p3 = mm1(R16, 6), mm1(R16, 7), m0(R16, 0), m0(R16, 1)
    rsp = _resp(_f4(p0, p1, p2, p3), limit)
    m = hfire[:, None, :]
    R16 = setk(R16, colsm1, 7, torch.where(m, _clamp(p1 + rsp), p1))
    R16 = setk(R16, cols0, 0, torch.where(m, _clamp(p2 - rsp), p2))
    R = _set(R, (slice(None), slice(1, 7)), R16)

    # ---- Phase B: bottom-edge chains, all rows ------------------------
    S6 = orig[:, 6]                                 # pre-P1
    S7 = orig[:, 7]
    band8 = R[:, 6]                                 # post-P1 row y0+6
    # Rows y0+8, y0+9 = next row's rows 0, 1, pre-P1.
    band10 = torch.cat([orig[1:, 0], bot0[None]])
    band11 = torch.cat([orig[1:, 1], bot1[None]])
    rS = _resp(_f4(mm1(S7, 6), mm1(S7, 7), m0(S7, 0), m0(S7, 1)), limit)
    h7S_m1 = _clamp(mm1(S7, 7) + rS)
    h7S_0 = _clamp(m0(S7, 0) - rS)
    fe6 = _f4(m0(S6, 6), m0(S7, 6), m0(band10, 6), m0(band11, 6))
    ve6_row7 = _clamp(m0(S7, 6) + _resp(fe6, limit))
    in6 = torch.where(nxt_coded, m0(S6, 7), m0(band8, 7))
    in7 = torch.where(
        nxt_coded, m0(S7, 7),
        torch.cat([h7S_m1[:, 1:], m0(S7, 7)[:, -1:]], dim=1),
    )
    fe7 = _f4(in6, in7, m0(band10, 7), m0(band11, 7))
    ve7_row7 = _clamp(in7 + _resp(fe7, limit))
    prev_vE = torch.cat([zcol, vE[:, :-1]], dim=1)
    use_post = prev_vE & left_fired
    in_m2b = torch.where(use_post, _shift_right(ve6_row7), mm1(S7, 6))
    in_m1b = torch.where(use_post, _shift_right(ve7_row7), mm1(S7, 7))
    rP = _resp(_f4(in_m2b, in_m1b, m0(S7, 0), m0(S7, 1)), limit)
    h7P_m1 = _clamp(in_m1b + rP)
    h7P_0 = _clamp(m0(S7, 0) - rP)
    h7_m1 = torch.where(left_fired, h7P_m1, h7S_m1)
    h7_0 = torch.where(left_fired, h7P_0, h7S_0)
    r_6 = S6[:, cols0, :]                           # [nv, nh, 8]
    r_7 = S7[:, cols0, :]
    r_8 = band10[:, cols0, :]
    r_9 = band11[:, cols0, :]
    r_6 = torch.where(c8 == 0, m0(band8, 0)[..., None], r_6)  # post-P1
    r_7 = torch.where(
        c8 == 0, torch.where(hfire, h7_0, r_7[:, :, 0])[..., None], r_7,
    )
    r_6 = torch.where(
        c8 == 7,
        torch.where(~nxt_coded, m0(band8, 7), m0(S6, 7))[..., None], r_6,
    )
    h_next_m1 = torch.cat([h7_m1[:, 1:], m0(S7, 7)[:, -1:]], dim=1)
    hfire_next = torch.cat([hfire[:, 1:], zcol], dim=1)
    r_7 = torch.where(
        c8 == 7,
        torch.where(~nxt_coded & hfire_next, h_next_m1,
                    r_7[:, :, 7])[..., None],
        r_7,
    )
    re = _resp(_f4(r_6, r_7, r_8, r_9), limit)
    out_7 = _clamp(r_7 + re)
    out_8 = _clamp(r_8 - re)
    mve = vE[:, :, None]
    # Row y0+7 writes (vE full application, then corner h writes).
    row7 = R[:, 7]
    row7 = _set(row7, (slice(None), cols0),
                torch.where(mve, out_7, row7[:, cols0, :]))
    keep_m1 = hfire & ~(prev_vE & ~left_fired)
    row7 = setk(row7, colsm1, 7, torch.where(keep_m1, h7_m1, mm1(row7, 7)))
    row7 = setk(row7, cols0, 0,
                torch.where(hfire & ~vE, h7_0, m0(row7, 0)))
    R = _set(R, (slice(None), 7), row7)
    # Row y0+8 = next row's row 0 (vE of the last row is masked off).
    row0_below = torch.where(mve, out_8, band10[:, cols0, :])
    R = _set(R, (slice(1, None), 0, cols0), row0_below[:-1])

    # ---- Phase A: top-edge chains, all rows ---------------------------
    b0 = torch.cat([top2[None], R[:-1, 6]])         # y0-2, post-P1
    b1 = torch.cat([top1[None], R[:-1, 7]])         # y0-1, post-B
    S0 = R[:, 0]                                    # y0, post-B
    S1 = orig[:, 1]                                 # y0+1 pre-P1
    f6 = _f4(m0(b0, 6), m0(b1, 6), m0(S0, 6), m0(S1, 6))
    vb6_row0 = _clamp(m0(S0, 6) - _resp(f6, limit))
    f7 = _f4(m0(b0, 7), m0(b1, 7), m0(S0, 7), m0(S1, 7))
    vb7_row0 = _clamp(m0(S0, 7) - _resp(f7, limit))
    prev_vL = torch.cat([zcol, vL[:, :-1]], dim=1)
    in_m2 = torch.where(prev_vL, _shift_right(vb6_row0), mm1(S0, 6))
    in_m1 = torch.where(prev_vL, _shift_right(vb7_row0), mm1(S0, 7))
    rh0 = _resp(_f4(in_m2, in_m1, m0(S0, 0), m0(S0, 1)), limit)
    h0_m1 = _clamp(in_m1 + rh0)
    h0_0 = _clamp(m0(S0, 0) - rh0)
    r_m2 = b0[:, cols0, :]
    r_m1 = b1[:, cols0, :]
    r_0 = S0[:, cols0, :]
    r_1 = S1[:, cols0, :]
    r_0 = torch.where(
        c8 == 0, torch.where(hfire, h0_0, r_0[:, :, 0])[..., None], r_0,
    )
    r_1 = torch.where(c8 == 0, m0(R[:, 1], 0)[..., None], r_1)  # post-P1
    rv = _resp(_f4(r_m2, r_m1, r_0, r_1), limit)
    out_m1 = _clamp(r_m1 + rv)
    out_0 = _clamp(r_0 - rv)
    mvl = vL[:, :, None]
    # Row y0-1 = previous row's row 7 (vL of row 0 is masked off).
    rowm1 = torch.where(mvl, out_m1, r_m1)
    R = _set(R, (slice(None, -1), 7, cols0), rowm1[1:])
    # Row y0 (vL full application, then corner h writes).
    row0 = R[:, 0]
    row0 = _set(row0, (slice(None), cols0),
                torch.where(mvl, out_0, row0[:, cols0, :]))
    row0 = setk(row0, colsm1, 7, torch.where(hfire, h0_m1, mm1(row0, 7)))
    row0 = setk(row0, cols0, 0,
                torch.where(hfire & ~vL, h0_0, m0(row0, 0)))
    R = _set(R, (slice(None), 0), row0)

    # I is this function's own int32 copy of the plane: write in place.
    I[pad_y:pad_y + 8 * nv] = R.reshape(8 * nv, W)
    return I.to(torch.uint8)
