"""Carry a stream's reference state into the port's batch decoder.

A stream whose decode began elsewhere (for example in
`theora_tpu.decode.tpu_batch.TpuBatchDecoder`) continues in
`BatchDecoder` once its resident prev/golden planes and counters are
loaded here. This is the codec's counterpart of carrying weights across.
"""
from __future__ import annotations

import numpy as np
import torch

from theora_tpu_torch.constants import FRAME_GOLD, FRAME_PREV, FRAME_SELF


def load_reference_state(dec, prev_planes, gold_planes, ref_idx: dict,
                         keyframe_num: int, curframe_num: int) -> None:
    """Put reference planes and counters into a `BatchDecoder`.

    prev_planes, gold_planes: three padded uint8 planes each, bitstream
    orientation (row 0 = display bottom), shaped as the decoder's
    geometry pads them. ref_idx: {FRAME_GOLD, FRAME_PREV, FRAME_SELF:
    slot}, as the source decoder kept it. The next packet decoded must
    follow the frame these planes end on.
    """
    g = dec.geometry
    refs = {}
    for pli in range(3):
        h, w = g.plane_shape(pli)
        vpad, hpad = g.plane_padding(pli)
        shape = (h + 2 * vpad, w + 2 * hpad)
        planes = []
        for name, p in (("prev", prev_planes[pli]), ("gold", gold_planes[pli])):
            p = np.asarray(p)
            if p.dtype != np.uint8 or p.shape != shape:
                raise ValueError(f"{name} plane {pli}: expected uint8 "
                                 f"{shape}, got {p.dtype} {p.shape}")
            planes.append(torch.from_numpy(p.copy()).to(dec.device))
        refs[pli] = tuple(planes)
    missing = {FRAME_GOLD, FRAME_PREV, FRAME_SELF} - set(ref_idx)
    if missing:
        raise ValueError(f"ref_idx lacks slots {sorted(missing)}")
    dec._refs = refs
    dec._last_out = None
    dec._pp_shown = False
    dec.ref_idx = {k: int(ref_idx[k])
                   for k in (FRAME_GOLD, FRAME_PREV, FRAME_SELF)}
    dec.keyframe_num = int(keyframe_num)
    dec.curframe_num = int(curframe_num)
