"""Host decoder state shared by the port's decoders.

Port of the part of theora_tpu/decode/decoder.py that the port's
decoders share: the dequant tables, the reference slots and frame counters
with `_update_granpos`, the native side-info parse `_parse_sideinfo_native`
(decode.c:442-981), and the decoder controls a user sets through
`th_decode_ctl` (compat.py): the postprocessing level with its per-frame
state (`set_pplevel`, `_pp_frame`; the filter itself is kernel KP, run by
decode/batch.py), the telemetry overlays (`set_telemetry`, drawn by
decode/telemetry.py) and the striped-decode callback (`stripe_callback`,
fired by decode/scalar.py). The pixel pipeline is BatchDecoder's
(decode/batch.py). Frames are in bitstream orientation (row 0 = display
bottom) in UMV-padded planes.
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch.constants import FRAME_GOLD, FRAME_PREV, FRAME_SELF
from theora_tpu_torch.geometry import get_geometry
from theora_tpu_torch.headers import SetupInfo
from theora_tpu_torch.info import INTRA_FRAME, TheoraInfo
from theora_tpu_torch.native import NativeEntropy, get_lib
from theora_tpu_torch.quant import dequant_tables_init, pp_dc_scale_init, \
    pp_sharp_mod

class BadPacketError(ValueError):
    """A data packet that the host parse (side info, tokens) rejects."""


class Decoder:
    """Stream-level decoder state (th_dec_ctx analogue) without a pixel
    pipeline of its own; `decode.batch.BatchDecoder` adds the device one.
    The native entropy library must build: there is no Python fallback.
    """

    def __init__(self, info: TheoraInfo, setup: SetupInfo):
        info.validate()
        self.info = info
        self.setup = setup
        self.geometry = get_geometry(
            info.frame_width, info.frame_height, int(info.pixel_fmt)
        )
        self.dequant = dequant_tables_init(setup.qinfo)  # [64,3,2,64]
        self._native = NativeEntropy(setup.codebooks)
        # Which of three reconstruction slots each reference occupies.
        self.ref_idx = {FRAME_GOLD: -1, FRAME_PREV: -1, FRAME_SELF: -1}
        self.keyframe_num = 0
        self.curframe_num = 0
        self.granpos = -1
        self.frame_type = -1
        self.qis: list[int] = []
        g = self.geometry
        self._si_arrays = (
            np.ascontiguousarray(g.scan_fragis, dtype=np.int32),
            np.ascontiguousarray(g.scan_sbi, dtype=np.int32),
            np.ascontiguousarray(g.scan_quadi, dtype=np.int32),
            np.ascontiguousarray(g.mb_maps.reshape(-1), dtype=np.int32),
            np.ascontiguousarray(g.mb_valid, dtype=np.uint8),
        )
        # Out-of-loop postprocessor (decode.c:1204-1325): the level, the
        # last DC qi of each fragment (None until the first intra frame
        # decoded at a level from 1; reset at level 0), and the
        # PERSISTENT per-fragment qii and 3-slot qi list: the reference
        # updates a fragment's qii only where it is coded and qis[1..2]
        # only when a frame carries them, so dering on an uncoded fragment
        # reads the qii it was last coded with, into a list whose upper
        # slots may be stale (decode.c:1928). Both are kept current on
        # every decoded frame, whatever the level.
        self.pp_level = 0
        self._pp_dc_qis: np.ndarray | None = None
        self._pp_qii_state = np.zeros(g.nfrags, np.uint8)
        self._pp_qis_state = np.zeros(3, np.uint8)
        self._pp_dc_scale = pp_dc_scale_init(setup.qinfo)
        self._pp_sharp_mod = pp_sharp_mod(self.dequant)
        # Telemetry overlays (TH_DECCTL_SET_TELEMETRY_*), and the state of
        # the last frame decoded while any was on.
        self.telemetry = {"mbmode": 0, "mv": 0, "qi": 0, "bits": 0}
        self._telemetry_state: dict | None = None
        # Striped-decode callback (TH_DECCTL_SET_STRIPE_CB): called as
        # callback(ycbcr, yfrag0, yfrag_end) per stripe of a decoded frame.
        self.stripe_callback = None

    def set_pplevel(self, level: int) -> None:
        """TH_DECCTL_SET_PPLEVEL analogue: 0 = off .. 7 = max
        (decode.c:31-48). Level 1 tracks the DC qis only; 2 deblocks
        luma; 3 derings luma too, 4 strongly; 5 deblocks all three
        planes; 6 derings chroma, 7 strongly."""
        if not 0 <= level <= 7:
            raise ValueError("pp level must be 0..7")
        self.pp_level = level

    def set_telemetry(self, mbmode=None, mv=None, qi=None, bits=None):
        """Turn the debug overlays on decoded output on or off
        (TH_DECCTL_SET_TELEMETRY_{MBMODE,MV,QI,BITS} analogue)."""
        for k, v in (("mbmode", mbmode), ("mv", mv), ("qi", qi),
                     ("bits", bits)):
            if v is not None:
                self.telemetry[k] = int(v)

    def _pp_frame(self, side: dict, qis: list[int], intra: bool):
        """The postprocessor's host state step for a decoded frame that
        codes blocks (theora_tpu/decode/decoder.py:212-265,492-493), in
        stream order. Returns None when the frame is not postprocessed,
        else (dc_qis [nfrags] uint8, qi per fragment [nfrags] uint8,
        level) as this frame's filter reads them.

        Level 0 clears the DC-qi tracking, as the reference's level-0
        branch intends: the JAX decoder never reaches that branch (it
        calls its postprocessor only from level 1), so after a switch to
        0 its output keeps returning the last postprocessed frame (fault
        F9); here the frame decodes without pp."""
        coded = side["coded"]
        self._pp_qis_state[:len(qis)] = qis
        self._pp_qii_state[coded] = side["qii"][coded]
        level = self.pp_level
        if level < 1:
            self._pp_dc_qis = None
            return None
        # DC qi tracking starts at the first intra frame
        # (decode.c:1220-1244).
        if self._pp_dc_qis is None:
            if not intra:
                return None
            self._pp_dc_qis = np.full(self.geometry.nfrags, qis[0], np.uint8)
        else:
            self._pp_dc_qis[coded] = qis[0]
        if level < 2:
            return None
        return (self._pp_dc_qis.copy(),
                self._pp_qis_state[self._pp_qii_state], level)

    def _parse_sideinfo_native(self, packet: bytes) -> dict:
        """Frame header, coded flags, MB modes, MVs and block qi indices
        via the C++ tier (decode.c:442-981). Sets frame_type and qis."""
        lib = get_lib()
        g = self.geometry
        sf, ssb, sq, mbm, mbv = self._si_arrays
        buf = np.frombuffer(packet, dtype=np.uint8)
        ft = np.zeros(1, np.int32)
        qis = np.zeros(3, np.int32)
        nqis = np.zeros(1, np.int32)
        coded = np.zeros(g.nfrags, np.uint8)
        refi = np.zeros(g.nfrags, np.int32)
        mode = np.zeros(g.nfrags, np.int32)
        mv = np.zeros((g.nfrags, 2), np.int32)
        qii = np.zeros(g.nfrags, np.int32)
        pos = lib.th_parse_frame_sideinfo(
            buf.ctypes.data, len(packet), g.nfrags, g.nsbs, g.nmbs,
            int(self.info.pixel_fmt), sf.ctypes.data, ssb.ctypes.data,
            sq.ctypes.data, len(sf), g.planes[0].nsbs, mbm.ctypes.data,
            mbv.ctypes.data, ft.ctypes.data, qis.ctypes.data,
            nqis.ctypes.data, coded.ctypes.data, refi.ctypes.data,
            mode.ctypes.data, mv.ctypes.data, qii.ctypes.data,
        )
        if pos < 0:
            raise BadPacketError("bad frame packet")
        self.frame_type = int(ft[0])
        self.qis = [int(q) for q in qis[: int(nqis[0])]]
        if self.frame_type == INTRA_FRAME:
            self.keyframe_num = self.curframe_num
        return {
            "coded": coded.astype(bool),
            "refi": refi,
            "mode": mode,
            "mv": mv,
            "qii": qii,
            "bitpos": int(pos),
        }

    def _update_granpos(self) -> None:
        shift = self.info.keyframe_granule_shift
        bias = 1  # streams are version 3.2.1 (state.c:748-752)
        self.granpos = ((self.keyframe_num + bias) << shift) + (
            self.curframe_num - self.keyframe_num
        )
        self.curframe_num += 1
