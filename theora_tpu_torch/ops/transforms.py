"""Plain PyTorch twins of the decode transforms.

Port of the decode side of theora_tpu/ops/transforms_jax.py (`_i16`,
`idct8`, `idct8x8`, `dc_fill`, `dequantize_idct`). All arithmetic is
int32 with the explicit int16 wrap where the spec stores int16, so the
results equal the C reference (idct.c:30-296, state.c:959-980).

`dequantize_idct_frames` is the function kernel K1 computes
(ops/idct_cuda.py): the CPU path of its wrapper and its oracle on the
card.
"""
from __future__ import annotations

import torch

from theora_tpu_torch.constants import (
    C1S7,
    C2S6,
    C3S5,
    C4S4,
    C5S3,
    C6S2,
    C7S1,
    ZIGZAG_TO_NAT,
)

_ZZ = torch.from_numpy(ZIGZAG_TO_NAT)


def _i16(x: torch.Tensor) -> torch.Tensor:
    """int16 wraparound in the int32 domain."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _mul16(c: int, x: torch.Tensor) -> torch.Tensor:
    """(c * x) >> 16 with c a positive constant < 2**16; |x| <= 2**15
    keeps the product inside int32."""
    return (c * x) >> 16


def idct8(x: torch.Tensor) -> torch.Tensor:
    """1-D 8-point iDCT along the last axis (idct.c:30-81); int32."""
    t0 = _mul16(C4S4, _i16(x[..., 0] + x[..., 4]))
    t1 = _mul16(C4S4, _i16(x[..., 0] - x[..., 4]))
    t2 = _mul16(C6S2, x[..., 2]) - _mul16(C2S6, x[..., 6])
    t3 = _mul16(C2S6, x[..., 2]) + _mul16(C6S2, x[..., 6])
    t4 = _mul16(C7S1, x[..., 1]) - _mul16(C1S7, x[..., 7])
    t5 = _mul16(C3S5, x[..., 5]) - _mul16(C5S3, x[..., 3])
    t6 = _mul16(C5S3, x[..., 5]) + _mul16(C3S5, x[..., 3])
    t7 = _mul16(C1S7, x[..., 1]) + _mul16(C7S1, x[..., 7])
    t4, t5 = t4 + t5, _mul16(C4S4, _i16(t4 - t5))
    t7, t6 = t7 + t6, _mul16(C4S4, _i16(t7 - t6))
    t0, t3 = t0 + t3, t0 - t3
    t1, t2 = t1 + t2, t1 - t2
    t6, t5 = t6 + t5, t6 - t5
    return torch.stack(
        [
            _i16(t0 + t7), _i16(t1 + t6), _i16(t2 + t5), _i16(t3 + t4),
            _i16(t3 - t4), _i16(t2 - t5), _i16(t1 - t6), _i16(t0 - t7),
        ],
        dim=-1,
    )


def idct8x8(coeffs: torch.Tensor) -> torch.Tensor:
    """Dense 2-D iDCT: [N, 8, 8] int32 natural-order coefficients ->
    [N, 8, 8] residuals; row pass, then column pass (idct.c:285-296)."""
    w = idct8(coeffs).transpose(-1, -2)
    y = idct8(w).transpose(-1, -2)
    return _i16((y + 8) >> 4)


def dc_fill(dc: torch.Tensor, dc_quant: torch.Tensor) -> torch.Tensor:
    """[N] -> [N, 8, 8]: DC-only blocks (state.c:967-975)."""
    p = _i16((dc * dc_quant + 15) >> 5)
    return p[:, None, None].expand(*p.shape, 8, 8)


def dequantize_idct(coeffs_zz, dequant_zz, dc, dc_quant, dc_only):
    """Reconstruct residual blocks.

    coeffs_zz: [N, 64] int32 quantized coefficients, zig-zag, DC slot
    ignored; dequant_zz: [N, 64] int32 factors (zig-zag); dc: [N]
    predicted DC; dc_quant: [N]; dc_only: [N] bool, the blocks that take
    the decoder's last_zzi < 2 path. Returns [N, 8, 8] int32.
    """
    deq = _i16(coeffs_zz * dequant_zz)
    deq[:, 0] = _i16(dc * dc_quant)  # deq is a fresh tensor: in place
    nat = torch.zeros_like(deq)
    nat[:, _ZZ.to(deq.device)] = deq
    full = idct8x8(nat.reshape(-1, 8, 8))
    return torch.where(dc_only[:, None, None], dc_fill(dc, dc_quant), full)


def dequantize_idct_frames(qz, dc, deq_tab, frame, qii, inter, dc_only):
    """Dequant + iDCT of the blocks of F frames of one plane (kernel K1's
    function; the decode scan's step at theora_tpu/decode/tpu_batch.py:
    85-111).

    qz: [N, 64] int16 zig-zag, DC slot ignored; dc: [N] int16 predicted
    DC; deq_tab: [F, 3, 2, 64] int16 per-frame dequant rows indexed
    (qii, inter); frame: [N] int32; qii, inter: [N] uint8; dc_only: [N]
    bool. The DC factor is deq_tab[frame, 0, inter, 0]. Returns [N, 64]
    int16 residuals in raster order inside each block.
    """
    tab = deq_tab.to(torch.int32)
    f = frame.long()
    t = inter.long()
    rows = tab[f, qii.long(), t]
    dcq = tab[f, 0, t, 0]
    res = dequantize_idct(qz.to(torch.int32), rows, dc.to(torch.int32), dcq,
                          dc_only)
    return res.reshape(-1, 64).to(torch.int16)
