"""Host decoder state shared by the port's decoders.

Port of the part of theora_tpu/decode/decoder.py that
`theora_tpu.decode.tpu_batch.TpuBatchDecoder` inherits from `Decoder`: the
dequant tables, the reference slots and frame counters with `_update_granpos`,
and the native side-info parse `_parse_sideinfo_native`
(decode.c:442-981). The scalar `decode_packet`, postprocessing and
telemetry are not in this slice. Frames are in bitstream orientation
(row 0 = display bottom) in UMV-padded planes.
"""
from __future__ import annotations

import numpy as np

from theora_tpu_torch.constants import FRAME_GOLD, FRAME_PREV, FRAME_SELF
from theora_tpu_torch.geometry import get_geometry
from theora_tpu_torch.headers import SetupInfo
from theora_tpu_torch.info import INTRA_FRAME, TheoraInfo
from theora_tpu_torch.native import NativeEntropy, get_lib
from theora_tpu_torch.quant import dequant_tables_init

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
            raise ValueError("bad frame packet")
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
