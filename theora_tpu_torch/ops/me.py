"""Batched motion estimation and the fused per-GOP decision precompute.

Port of theora_tpu/ops/me_jax.py (`_me_search_impl`, `_top_cands_impl`,
`_cand_sads_impl`, `_sad_intra_impl`, `_block_refine_impl`, `_plan_impl`,
`plan_from_gop`, `plan_with_gold`), plain PyTorch on the device. Every
macroblock of every frame is searched at once; the arithmetic is integer,
so the results equal the JAX package's exactly, tie order included:

  1. coarse: exhaustive +-7 full-pel search on a 2x sum-pooled pyramid,
     candidates in radius order (`_coarse_cands`);
  2. refine: +-2 full-pel window around the doubled coarse vector;
  3. half-pel: the 8 half-pel neighbours scored with the exact two-tap
     prediction of the reconstruction (state.c:846-957).

The JAX package's TPU workarounds are not carried over: the search
windows are gathered directly from the edge-padded reference (no
neighbourhood tensors and one-hot matmuls), and box sums are integer
reductions (no float32 matmuls). Minima are taken over explicit integer
keys (cost * stride + candidate rank), never over ties.

The search runs on the original (source) previous and golden frames, as
the reference's OC_FRAME_*_ORIG design does (mcenc.c:314-316), so every
frame of a GOP is independent.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from theora_tpu_torch import transfer

_COARSE_R = 7
_REFINE_R = 2
_MV_MAX = 15      # full-pel; half-pel range is +-31 (bitstream limit)
N_CANDS = 16      # shared candidate vectors scored per frame
_I32_MAX = 2 ** 31 - 1


@functools.lru_cache(None)
def _radius_order(r: int) -> np.ndarray:
    """(dy, dx) displacements in [-r, r]^2 sorted by radius, then
    lexicographically (ties prefer short vectors)."""
    ds = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    ds.sort(key=lambda d: (d[0] * d[0] + d[1] * d[1], d))
    return np.asarray(ds, dtype=np.int64)


@functools.lru_cache(None)
def _refine_rank() -> np.ndarray:
    """rank[ey*5+ex] = radius-order position of offset (ey-2, ex-2)."""
    rank = np.empty(25, np.int64)
    for r, (dy, dx) in enumerate(_radius_order(_REFINE_R)):
        rank[(dy + 2) * 5 + (dx + 2)] = r
    return rank


def _box(x: torch.Tensor, mb: int) -> torch.Tensor:
    """[F, H, W] -> [F, H//mb, W//mb] int32 box sums."""
    F, H, W = x.shape
    return (x.to(torch.int32).reshape(F, H // mb, mb, W // mb, mb)
            .sum(dim=(2, 4), dtype=torch.int32))


def _edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-replicating pad of the last two dims of [F, H, W]."""
    F, H, W = x.shape
    rows = torch.clamp(torch.arange(-p, H + p, device=x.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-p, W + p, device=x.device), 0, W - 1)
    return x[:, rows][:, :, cols]


class _Patches:
    """Per-MB windows of a reference: pixel (mb_y + py + s, mb_x + px + t)
    of the 16-pixel edge-padded plane, where the JAX package reads the
    same pixels from its 48x48 neighbourhood tensor."""

    def __init__(self, ref: torch.Tensor):
        F, H, W = ref.shape
        self.refp = _edge_pad(ref, 16).reshape(-1)
        self.Wp = W + 32
        dev = ref.device
        r = torch.arange(H // 16, device=dev)[:, None] * 16 + 16
        c = torch.arange(W // 16, device=dev)[None, :] * 16 + 16
        self.origin = (torch.arange(F, device=dev)[:, None] * (H + 32)
                       * self.Wp + (r * self.Wp + c).reshape(1, -1))  # [F, n]

    def get(self, py: torch.Tensor, px: torch.Tensor, S: int) -> torch.Tensor:
        """py, px: [F, n] int64 -> [F, n, S, S] int32."""
        steps = torch.arange(S, device=py.device)
        base = self.origin + py * self.Wp + px                  # [F, n]
        idx = (base[:, :, None, None] + steps[:, None] * self.Wp
               + steps[None, :])
        return self.refp[idx].to(torch.int32)


def _mb_blocks(x: torch.Tensor, size: int, off_y: int = 0,
               off_x: int = 0) -> torch.Tensor:
    """[F, H, W] -> [F, n, size, size] int32: the size x size block at
    (off_y, off_x) of each macroblock, macroblocks in raster order."""
    F, H, W = x.shape
    nv, nh = H // 16, W // 16
    v = x.reshape(F, nv, 16, nh, 16)[:, :, off_y:off_y + size, :,
                                     off_x:off_x + size]
    return v.permute(0, 1, 3, 2, 4).reshape(F, nv * nh, size, size) \
        .to(torch.int32)


def _refine_select(grid, by, bx, mv_max):
    """First-by-radius-rank minimum over the in-range cells of a 5x5
    refine grid (me_jax._refine_select). grid: [F, n, 25] SADs, cell
    (ey, ex) scoring offset (by+ey-2, bx+ex-2). Returns (sad, oy, ox)."""
    dev = grid.device
    steps = torch.arange(25, device=dev)
    oy = by[..., None] + steps // 5 - 2
    ox = bx[..., None] + steps % 5 - 2
    valid = (oy.abs() <= mv_max) & (ox.abs() <= mv_max)
    rank = transfer.upload(_refine_rank(), dev)
    # sad <= 65280, so sad * 32 + rank < 2**22: unique keys.
    key = torch.where(valid, grid.to(torch.int64) * 32 + rank, _I32_MAX)
    kmin, idx = key.min(dim=-1)
    return kmin >> 5, by + idx // 5 - 2, bx + idx % 5 - 2


def _halfpel_select(taps, cur_blk, best_y, best_x):
    """Score the 8 half-pel neighbours and the full-pel centre with the
    exact two-tap prediction; the radius-order first minimum as (sad, my,
    mx) in half-pel units (me_jax._halfpel_select).

    taps[ry][rx]: [F, n, S, S] ref pixels at full-pel offset
    (best_y-1+ry, best_x-1+rx); cur_blk [F, n, S, S]."""
    def psad(a, b):
        pred2 = taps[a[0]][a[1]] + taps[b[0]][b[1]]
        return (cur_blk - (pred2 >> 1)).abs().sum(dim=(2, 3))

    pair = {-1: (0, 1), 1: (1, 2)}
    sads = {
        (0, 0): psad((1, 1), (1, 1)),
        (-1, 0): psad((0, 1), (1, 1)),
        (1, 0): psad((1, 1), (2, 1)),
        (0, -1): psad((1, 0), (1, 1)),
        (0, 1): psad((1, 1), (1, 2)),
    }
    for dy in (-1, 1):
        for dx in (-1, 1):
            (y0, y1), (x0, x1) = pair[dy], pair[dx]
            agree = ((2 * best_y + dy) >= 0) == ((2 * best_x + dx) >= 0)
            sads[(dy, dx)] = torch.where(agree, psad((y0, x0), (y1, x1)),
                                         psad((y0, x1), (y1, x0)))
    order = sorted(sads, key=lambda d: (d[0] * d[0] + d[1] * d[1], d))
    best = torch.full_like(sads[(0, 0)], _I32_MAX)
    bmy = torch.zeros_like(best_y)
    bmx = torch.zeros_like(best_x)
    for dy, dx in order:
        s = sads[(dy, dx)]
        better = s < best
        best = torch.where(better, s, best)
        bmy = torch.where(better, 2 * best_y + dy, bmy)
        bmx = torch.where(better, 2 * best_x + dx, bmx)
    return best, bmy, bmx


def _me_search(cur, ref):
    """Returns (mv [F, nv, nh, 2] half-pel (dx, dy), sad_mv [F, nv, nh],
    sad_nomv [F, nv, nh]), int64 / int32."""
    F, H, W = cur.shape
    nv, nh = H // 16, W // 16
    n = nv * nh
    dev = cur.device

    # ---- coarse, half resolution: candidates in radius order, keyed
    # (sad * 256 + candidate index) so the first minimum wins.
    cur2 = _box(cur, 2)
    R2 = _COARSE_R + 1
    ref2p = _edge_pad(_box(ref, 2), R2)
    H2, W2 = H // 2, W // 2
    cands = _radius_order(_COARSE_R)
    best_key = torch.full((F, nv, nh), _I32_MAX, dtype=torch.int64,
                          device=dev)
    for k, (dy, dx) in enumerate(cands):
        shifted = ref2p[:, R2 + dy:R2 + dy + H2, R2 + dx:R2 + dx + W2]
        sad = _box((cur2 - shifted).abs(), 8)
        best_key = torch.minimum(best_key, sad.to(torch.int64) * 256 + k)
    cand_t = transfer.upload(cands, dev)
    c_d = cand_t[best_key & 255]                     # [F, nv, nh, 2] (dy, dx)

    # ---- full-pel refine around 2x coarse
    patches = _Patches(ref)
    cur_mb = _mb_blocks(cur, 16)
    by = (2 * c_d[..., 0]).reshape(F, n)
    bx = (2 * c_d[..., 1]).reshape(F, n)
    patch = patches.get(by - 2, bx - 2, 20)
    grid = torch.stack([
        (patch[:, :, ry:ry + 16, rx:rx + 16] - cur_mb).abs().sum(dim=(2, 3))
        for ry in range(5) for rx in range(5)], dim=-1)
    _, best_y, best_x = _refine_select(grid, by, bx, _MV_MAX)

    # ---- half-pel refine: one 18x18 patch at (f-1) holds every tap.
    patch = patches.get(best_y - 1, best_x - 1, 18)
    taps = [[patch[:, :, ry:ry + 16, rx:rx + 16] for rx in range(3)]
            for ry in range(3)]
    best_hsad, best_my, best_mx = _halfpel_select(taps, cur_mb, best_y,
                                                  best_x)
    h_m = torch.stack([best_mx, best_my], dim=-1).reshape(F, nv, nh, 2)
    sad_nomv = _box((cur.to(torch.int32) - ref.to(torch.int32)).abs(), 16)
    return h_m, best_hsad.reshape(F, nv, nh), sad_nomv


def _top_cands(mv, K=N_CANDS):
    """Top-K shared candidate vectors per frame by best-MV popularity,
    ties broken (count desc, dx asc, dy asc); zero rows past the last
    nonzero-count candidate. mv: [F, nv, nh, 2] (dx, dy)."""
    F = mv.shape[0]
    dx = mv[..., 0].reshape(F, -1)
    dy = mv[..., 1].reshape(F, -1)
    bins = (dx + 31) * 63 + (dy + 31)
    nz = ((dx != 0) | (dy != 0)).to(torch.int64)
    counts = torch.zeros((F, 63 * 63), dtype=torch.int64, device=mv.device)
    counts.scatter_add_(1, bins, nz)
    # Unique keys: count desc, then bin (= (dx, dy) lex order) asc.
    score = counts * 4096 + (4095 - torch.arange(63 * 63, device=mv.device))
    idx = torch.sort(score, dim=1, descending=True, stable=True)[1][:, :K]
    cnt = torch.gather(counts, 1, idx)
    cand = torch.stack([idx // 63 - 31, idx % 63 - 31], dim=-1)
    return torch.where((cnt > 0)[..., None], cand, 0)


def _cand_sads(cur, ref, cand):
    """SAD of every MB against each frame's K shared half-pel candidates
    with the exact two-tap prediction. Returns [F, K, nv, nh]."""
    F, H, W = cur.shape
    PAD = 17
    curi = cur.to(torch.int32)
    refp = _edge_pad(ref, PAD).to(torch.int32)
    dev = cur.device
    fi = torch.arange(F, device=dev)[:, None, None]
    ar_h = torch.arange(H, device=dev)
    ar_w = torch.arange(W, device=dev)
    out = []
    for k in range(cand.shape[1]):
        mx, my = cand[:, k, 0], cand[:, k, 1]
        o1y = torch.sign(my) * (my.abs() >> 1)
        o1x = torch.sign(mx) * (mx.abs() >> 1)
        o2y = o1y + torch.sign(my) * (my.abs() & 1)
        o2x = o1x + torch.sign(mx) * (mx.abs() & 1)

        def shifted(oy, ox):
            rows = (PAD + oy)[:, None] + ar_h              # [F, H]
            cols = (PAD + ox)[:, None] + ar_w              # [F, W]
            return refp[fi, rows[:, :, None], cols[:, None, :]]

        pred = (shifted(o1y, o1x) + shifted(o2y, o2x)) >> 1
        out.append(_box((curi - pred).abs(), 16))
    return torch.stack(out, dim=1)


def _sad_intra(cur):
    """Per-MB sum over its four 8x8 luma blocks of the absolute deviation
    from the block mean."""
    F, H, W = cur.shape
    nv, nh = H // 16, W // 16
    b8 = (cur.to(torch.int32).reshape(F, nv * 2, 8, nh * 2, 8)
          .permute(0, 1, 3, 2, 4).reshape(F, nv * 2, nh * 2, 64))
    mean = b8.sum(dim=-1, keepdim=True, dtype=torch.int32) >> 6
    dev_ = (b8 - mean).abs().sum(dim=-1, dtype=torch.int32)
    return dev_.reshape(F, nv, 2, nh, 2).sum(dim=(2, 4), dtype=torch.int32)


def _block_refine(cur, ref, mv):
    """Per-8x8-block MV refine around each parent MB's winner (the 4MV
    search): +-2 full-pel grid then the 8 half-pel neighbours, block
    candidates clamped to +-13 full-pel. Returns (bmv [F, 2nv, 2nh, 2],
    bsad [F, 2nv, 2nh])."""
    F, H, W = cur.shape
    nv, nh = H // 16, W // 16
    n = nv * nh
    patches = _Patches(ref)
    mx, my = mv[..., 0], mv[..., 1]
    base_x = torch.clamp((torch.sign(mx) * (mx.abs() >> 1)).reshape(F, n),
                         -13, 13)
    base_y = torch.clamp((torch.sign(my) * (my.abs() >> 1)).reshape(F, n),
                         -13, 13)
    out_mv = torch.zeros((F, 2 * nv, 2 * nh, 2), dtype=mv.dtype,
                         device=cur.device)
    out_sad = torch.zeros((F, 2 * nv, 2 * nh), dtype=torch.int32,
                          device=cur.device)
    for jy in (0, 1):
        for jx in (0, 1):
            cur_blk = _mb_blocks(cur, 8, 8 * jy, 8 * jx)
            patch = patches.get(8 * jy + base_y - 2, 8 * jx + base_x - 2, 12)
            grid = torch.stack([
                (patch[:, :, ry:ry + 8, rx:rx + 8] - cur_blk).abs()
                .sum(dim=(2, 3))
                for ry in range(5) for rx in range(5)], dim=-1)
            _, best_y, best_x = _refine_select(grid, base_y, base_x, 13)
            patch = patches.get(8 * jy + best_y - 1, 8 * jx + best_x - 1, 10)
            taps = [[patch[:, :, ry:ry + 8, rx:rx + 8] for rx in range(3)]
                    for ry in range(3)]
            b_hsad, b_my, b_mx = _halfpel_select(taps, cur_blk, best_y,
                                                 best_x)
            out_mv[:, jy::2, jx::2] = torch.stack(
                [b_mx, b_my], dim=-1).reshape(F, nv, nh, 2)
            out_sad[:, jy::2, jx::2] = b_hsad.reshape(F, nv, nh).to(
                torch.int32)
    return out_mv, out_sad


def plan(cur, prev, gold):
    """Fused ME + SADs + candidate selection for B independent frames
    (me_jax._plan_impl). cur/prev/gold: [B, H, W] uint8. Returns the 11
    int32 arrays (mv [B,nv,nh,2], sad_mv, sad_nomv, sad_gold, sad_intra
    [B,nv,nh], cands [B,K,2], cand_sads [B,K,nv,nh], gmv [B,nv,nh,2],
    sad_gmv [B,nv,nh], bmv [B,2nv,2nh,2], bsad4 [B,nv,nh]); vectors are
    half-pel (dx, dy)."""
    mv, sad_mv, sad_nomv = _me_search(cur, prev)
    gmv, sad_gmv, sad_gold = _me_search(cur, gold)
    bmv, bsad = _block_refine(cur, prev, mv)
    B, nv2, nh2 = bsad.shape
    # The mode decision reads only each MB's sum of its four block SADs.
    bsad4 = bsad.reshape(B, nv2 // 2, 2, nh2 // 2, 2).sum(
        dim=(2, 4), dtype=torch.int32)
    sad_intra = _sad_intra(cur)
    cands = _top_cands(mv)
    cand_sads = _cand_sads(cur, prev, cands)
    return tuple(t.to(torch.int32) for t in (
        mv, sad_mv, sad_nomv, sad_gold, sad_intra, cands, cand_sads, gmv,
        sad_gmv, bmv, bsad4))


def plan_with_gold(ys, gold_idx):
    """Fused plan for a frame sequence in one call: ys [F, H, W] uint8,
    gold_idx [F-1] int64 giving, for each cur frame f+1, the index in ys
    of its golden reference (its GOP's keyframe). Rows whose cur frame is
    itself a keyframe are computed and left for the caller to discard."""
    return plan(ys[1:], ys[:-1], ys[gold_idx])


def plan_from_gop(ys):
    """Fused plan for one GOP: ys [F, H, W] uint8, frame 0 the keyframe
    and the golden reference of every other frame."""
    gold_idx = torch.zeros(ys.shape[0] - 1, dtype=torch.int64,
                           device=ys.device)
    return plan_with_gold(ys, gold_idx)
