"""K8 (csrc/int8_conv.cu) on the CPU: what surrounds the kernel, and a numpy model of its indexing.

The kernel runs only on the card. Here:
- the op on a bf16 or fp32 input equals the op on `quantize_act` of it, bit
  for bit (the plain version quantizes first, as the kernel does in its
  load), and `torch.library.opcheck` passes for the float-input signature;
- `QConv` hands a float input to the op unquantized;
- a numpy model of the gemm route's index maps, step by step as the kernel
  runs them: the loader's (M tile row, K step) -> (b, iy, ix, c) with
  zero-fill for the padding, the stride and the Cin tail, the shared-memory
  core-matrix offsets the copies write and the wgmma descriptors read, the
  accumulator fragment's (row, column), and the staged tile's coalesced
  stores; held to `F.conv2d` on every kind of yolo11n conv and on the tails
  (Cin 8, 16, 48, 80; Cout 8, 80, 256, 512; odd frames, stride 2, a partial
  M tile). The depthwise route's weight and channel indexing likewise.
A change to the kernel's indexing can be checked here before the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yololite_tpu_torch.models import modules as M
from yololite_tpu_torch.ops import kernels as K

CHUNK = 32  # K bytes per step, one wgmma k32
N_TILES = (128, 80, 64, 32, 16, 8)  # the kernel's instantiated N tiles, widest first


def _swizzled_offset(row, k):
    """A tile's (row, K byte) in its slot: 32-byte rows, the 16-byte halves of rows 4-7 of each 8 swapped."""
    off = row * CHUNK + k
    return off ^ (((off >> 7) & 1) << 4)


def _descriptor_read(slot, base, rows):
    """What wgmma reads through a 32-byte-swizzle descriptor at `base`: rows x 32 K bytes. The hardware's
    swizzle is on address bits (bit 4 ^= bit 7) of 256-byte-aligned atoms, so it is the writer's map."""
    r, k = np.arange(rows)[:, None], np.arange(CHUNK)[None, :]
    logical = r * CHUNK + k
    return slot[base + (logical ^ (((logical >> 7) & 1) << 4))]


def _plan(b, cin, ho, wo, cout, groups):
    """csrc/int8_conv.cu plan() for the gemm route: (N tile, consumer warpgroups, copy granule)."""
    assert groups == 1 and cin % 8 == 0 and cout % 8 == 0
    bn = next(n for n in N_TILES if n == cout or (cout > n and cout % n == 0))
    tiles128 = -(-b * ho * wo // 128) * (cout // bn)
    return bn, 2 if tiles128 >= 2 * 132 else 1, 16 if cin % 16 == 0 else 8


def _umulhi_div(n, d):
    """The kernel's division of n < 2^16 by d: the high word of n * (floor((2^32 - 1) / d) + 1)."""
    return n if d == 1 else (n * ((0xFFFFFFFF // d) + 1)) >> 32


def _gemm_model(x, w, stride, pad, bn, wg, granule, chunks=2, flat=None, offset=0, pitch=None):
    """The gemm route on int8 NHWC x and OHWI w, as the kernel indexes it: int32 NHWC accumulators.

    K = taps x Cin is walked flat (k = (ky * kw + kx) * Cin + c) in steps of `chunks` chunks of 32; each
    16-byte K half (or 8-byte piece) finds its tap and channel from k, and a step runs one wgmma per chunk
    that has K indices. With `flat`, x is a channel slice of a wider tensor: its pixels `pitch` elements apart in
    `flat`, from `offset` (the kernel's x pointer)."""
    b, h, wi, cin = x.shape
    pitch = cin if pitch is None else pitch
    cout, kh, kw, _ = w.shape
    ho, wo = (h + 2 * pad - kh) // stride + 1, (wi + 2 * pad - kw) // stride + 1
    m_all, bm, threads = b * ho * wo, 64 * wg, 128 * wg
    K = kh * kw * cin
    steps = -(-K // (chunks * CHUNK))
    xf, wf = (x.reshape(-1) if flat is None else flat), w.reshape(-1)
    out = np.full((m_all, cout), -(2 ** 31), np.int64)  # every element must be written once
    tid = np.arange(threads)
    row, half = tid >> 1, tid & 1
    pieces = ((0, 16),) if granule == 16 else ((0, 8), (8, 8))
    for m0 in range(0, m_all, bm):
        m = m0 + row
        row_ok = m < m_all
        bi = np.where(row_ok, m // (ho * wo), 0)
        rem = np.where(row_ok, m - bi * ho * wo, 0)
        oy, ox = rem // wo, rem % wo
        iy0, ix0 = oy * stride - pad, ox * stride - pad
        xrow = offset + ((bi * h + iy0) * wi + ix0) * pitch

        def x_offset(k):  # per thread: the x index of K index k, or -1 for a zero
            tap = _umulhi_div(k, cin)
            c = k - tap * cin
            ky = _umulhi_div(tap, kw)
            kx = tap - ky * kw
            iy, ix = iy0 + ky, ix0 + kx
            ok = row_ok & (k < K) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wi)
            return np.where(ok, xrow + (ky * wi + kx) * pitch + c, -1)

        for n0 in range(0, cout, bn):
            acc = np.zeros((bm, bn), np.int64)
            for step in range(steps):
                k0 = step * chunks * CHUNK
                sa = np.zeros(chunks * bm * CHUNK, np.int64)
                sb = np.zeros(chunks * bn * CHUNK, np.int64)
                for kc in range(chunks):
                    if k0 + kc * CHUNK >= K:
                        break
                    for off, n in pieces:  # cp.async of n bytes, src-size n or 0
                        src = x_offset(k0 + kc * CHUNK + half * 16 + off)
                        ok = src >= 0
                        for j in range(n):
                            dst = kc * bm * CHUNK + _swizzled_offset(row, half * 16 + off + j)
                            sa[dst[ok]] = xf[src[ok] + j]
                for task in range(2 * bn * chunks):  # the B copies, spread over the threads
                    kc, nn, hb = task // (2 * bn), (task >> 1) % bn, task & 1
                    if k0 + kc * CHUNK >= K:
                        continue
                    for off, n in pieces:
                        k = k0 + kc * CHUNK + hb * 16 + off
                        if k < K:
                            for j in range(n):
                                dst = kc * bn * CHUNK + _swizzled_offset(nn, hb * 16 + off + j)
                                sb[dst] = wf[(n0 + nn) * K + k + j]
                # each warpgroup's wgmmas: A rows 64 wg.. (start + wg * 64 * 32), B all bn rows
                for kc in range(min(chunks, -(-(K - k0) // CHUNK))):
                    for gr in range(wg):
                        a = _descriptor_read(sa, kc * bm * CHUNK + gr * 64 * CHUNK, 64)
                        acc[gr * 64:(gr + 1) * 64] += a @ _descriptor_read(sb, kc * bn * CHUNK, bn).T
            # the accumulator fragment -> the staged tile -> the output rows
            staged = np.full((bm, bn), -(2 ** 31), np.int64)
            for t in range(threads):
                gr, tl = t >> 7, t & 127
                for i in range(bn // 2):
                    j, e = i // 4, i % 4
                    r = gr * 64 + 16 * (tl // 32) + (tl % 32) // 4 + 8 * (e // 2)
                    col = 8 * j + 2 * (tl % 4) + e % 2
                    assert staged[r, col] == -(2 ** 31)
                    staged[r, col] = acc[r, col]  # thread t holds acc[r, col] as d[i]
            rows = min(bm, m_all - m0)
            out[m0:m0 + rows, n0:n0 + bn] = staged[:rows]
    assert (out != -(2 ** 31)).all()
    return out.reshape(b, ho, wo, cout)


def test_loader_division_is_exact():
    """The loader's k / Cin and tap / kw by multiply-high: exact for every k < 2^16 and every divisor used."""
    k = np.arange(65536, dtype=np.int64)
    for d in (1, 3, 8, 16, 32, 48, 64, 80, 96, 128, 192, 256, 384, 512, 768, 1024):
        np.testing.assert_array_equal(_umulhi_div(k, d), k // d)


def _reference(x, w, stride, pad, groups=1):
    xt = torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w.astype(np.float64)).permute(0, 3, 1, 2)
    return F.conv2d(xt, wt, None, stride, pad, 1, groups).permute(0, 2, 3, 1).numpy().astype(np.int64)


# (name, batch, Cin, H, W, Cout, k, stride): yolo11n's gemm conv kinds, and the tails
GEMM_CASES = [
    ("1x1", 2, 64, 5, 7, 64, 1, 1),
    ("1x1-cin8", 1, 8, 6, 6, 16, 1, 1),
    ("1x1-cin48-cout8", 1, 48, 4, 9, 8, 1, 1),
    ("1x1-cin80-cout80", 2, 80, 5, 5, 80, 1, 1),
    ("3x3", 1, 16, 7, 6, 32, 3, 1),
    ("3x3-s2-odd", 1, 32, 9, 7, 64, 3, 2),
    ("3x3-cin16-cout256", 1, 16, 4, 4, 256, 3, 1),
    ("1x1-cout512", 1, 32, 3, 3, 512, 1, 1),
    ("3x3-cin8", 1, 8, 6, 5, 16, 3, 1),
    ("3x3-s2-cin48", 1, 48, 7, 7, 32, 3, 2),
]


@pytest.mark.parametrize("case", GEMM_CASES, ids=[c[0] for c in GEMM_CASES])
@pytest.mark.parametrize("wg", [1, 2])
def test_gemm_index_model_matches_conv(case, wg):
    """The numpy model of the gemm route's copies, descriptors, fragments and stores equals F.conv2d, exactly."""
    _, b, cin, h, wd, cout, k, stride = case
    rng = np.random.default_rng(cin * 7 + cout + k)
    x = rng.integers(-127, 128, (b, h, wd, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8)
    bn, _, granule = _plan(b, cin, (h + 2 * (k // 2) - k) // stride + 1, (wd + 2 * (k // 2) - k) // stride + 1,
                           cout, 1)
    got = _gemm_model(x, w, stride, k // 2, bn, wg, granule)
    np.testing.assert_array_equal(got, _reference(x, w, stride, k // 2))


# (name, batch, Cin, pitch (the whole tensor's channels), channel offset, H, W, Cout, k, stride): channel-split views
# as route 1 reads them in place (C3k2's Bottleneck cv1 and C2PSA's halves): either half, Cin 8 (8-byte copies), 16,
# 32, 48 and 64, stride 1 and 2, 3x3 and 1x1
SPLIT_CASES = [
    ("3x3-cin8-second-half", 1, 8, 16, 8, 6, 5, 16, 3, 1),
    ("3x3-cin16-first-half-s2", 1, 16, 32, 0, 7, 6, 16, 3, 2),
    ("3x3-cin32-second-half", 2, 32, 64, 32, 5, 7, 32, 3, 1),
    ("3x3-cin48-second-half-s2", 1, 48, 96, 48, 7, 7, 32, 3, 2),
    ("3x3-cin64-second-half-cout256", 1, 64, 128, 64, 4, 4, 256, 3, 1),
    ("1x1-cin64-second-half", 2, 64, 128, 64, 5, 7, 64, 1, 1),
    ("1x1-cin8-first-half", 1, 8, 24, 0, 6, 6, 16, 1, 1),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("wg", [1, 2])
def test_gemm_index_model_reads_split_views_in_place(case, wg):
    """The gemm route's loader on a channel slice of a channels-last tensor (pixels `pitch` elements apart, x's
    pointer at the slice's first channel) reads the same values as on the slice's copy: equal to F.conv2d, exactly."""
    _, b, cin, pitch, offset, h, wd, cout, k, stride = case
    rng = np.random.default_rng(cin * 5 + pitch + k)
    full = rng.integers(-127, 128, (b, h, wd, pitch)).astype(np.int8)
    x = np.ascontiguousarray(full[..., offset:offset + cin])
    w = rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8)
    bn, _, granule = _plan(b, cin, (h + 2 * (k // 2) - k) // stride + 1, (wd + 2 * (k // 2) - k) // stride + 1,
                           cout, 1)
    assert pitch % granule == 0  # plan(): an int8 pitch of whole copies
    got = _gemm_model(x, w, stride, k // 2, bn, wg, granule, flat=full.reshape(-1), offset=offset, pitch=pitch)
    np.testing.assert_array_equal(got, _reference(x, w, stride, k // 2))


def test_plan_picks_the_tiles_the_kernel_has():
    """yolo11n's Cout up to 128 each get their own N tile, 256 and 512 two and four of 128; small grids take the
    64-pixel M tile."""
    for cout in (8, 16, 32, 64, 80, 128):
        assert _plan(32, 64, 80, 80, cout, 1)[0] == cout
    assert _plan(1, 64, 4, 4, 256, 1)[0] == 128 and _plan(1, 64, 4, 4, 512, 1)[0] == 128
    assert _plan(1, 64, 4, 4, 96, 1)[0] == 32 and _plan(1, 64, 4, 4, 48, 1)[0] == 16
    assert _plan(32, 256, 10, 10, 128, 1)[1] == 1  # 25 tiles of 128 pixels would not fill 132 SMs twice
    assert _plan(32, 64, 80, 80, 64, 1)[1] == 2
    assert _plan(1, 8, 4, 4, 16, 1)[2] == 8 and _plan(1, 48, 4, 4, 16, 1)[2] == 16


def test_depthwise_index_model_matches_conv():
    """The depthwise route's indexing: channel c's tap t at byte 9c + t of the 16 channels' 144 weight bytes."""
    rng = np.random.default_rng(11)
    b, c, h, wd, stride = 2, 32, 7, 5, 2
    x = rng.integers(-127, 128, (b, h, wd, c)).astype(np.int8)
    w = rng.integers(-127, 128, (c, 3, 3, 1)).astype(np.int8)
    ho, wo = (h + 2 - 3) // stride + 1, (wd + 2 - 3) // stride + 1
    got = np.zeros((b, ho, wo, c), np.int64)
    wf = w.reshape(-1)
    for g in range(c // 16):
        c0 = 16 * g
        wr = wf[9 * c0:9 * c0 + 144].astype(np.int64)
        for bi in range(b):
            for oy in range(ho):
                for ox in range(wo):
                    for t in range(9):
                        iy, ix = oy * stride - 1 + t // 3, ox * stride - 1 + t % 3
                        if 0 <= iy < h and 0 <= ix < wd:
                            xv = x[bi, iy, ix, c0:c0 + 16].astype(np.int64)
                            got[bi, oy, ox, c0:c0 + 16] += xv * wr[9 * np.arange(16) + t]
    np.testing.assert_array_equal(got, _reference(x, w, stride, 1, groups=c))


def _conv_args(rng, cin, cout, k, groups=1):
    w = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, cin // groups)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(2e-4, 2e-3, cout).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, cout).astype(np.float32))
    return w, scale, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("sout", [0.05, 0.0], ids=["int8-out", "bf16-out"])
def test_float_input_equals_quantize_then_conv(dtype, sout):
    """On the CPU, the op on a float x equals the op on quantize_act(x, sin), bit for bit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 2, (2, 16, 9, 7)).astype(np.float32)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    w, scale, bias = _conv_args(rng, 16, 24, 3)
    sin = 0.02
    got = K.int8_conv(x, w, scale, bias, 2, 1, 1, 1, sout, sin)
    xq = K.quantize_act(x, torch.tensor(sin, dtype=torch.float32))
    want = K.int8_conv(xq, w, scale, bias, 2, 1, 1, 1, sout)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert int((xq.abs() == 127).sum()) > 0 and int((xq == 0).sum()) < xq.numel()


def test_float_input_op_passes_opcheck():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 6, 5)).astype(np.float32)).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, scale, bias = _conv_args(rng, 8, 16, 1)
    torch.library.opcheck(torch.ops.yololite_tpu_torch.int8_conv.default,
                          (x, w, scale, bias, 1, 0, 1, 1, 0.02, 0.01))
    with pytest.raises(TypeError):  # a float x needs its scale
        K.int8_conv(x, w, scale, bias)
    with pytest.raises(TypeError):
        K.int8_conv(x.half(), w, scale, bias, sin=0.01)


def test_qconv_hands_floats_to_the_op(monkeypatch):
    """QConv passes a bf16 input and its sin to K8 unquantized; the output equals quantize-then-conv."""
    rng = np.random.default_rng(5)
    w, _, bias = _conv_args(rng, 3, 16, 3)
    q = M.QConv(w, torch.full((16,), 0.01), bias, 0.0125, 0.05, stride=2, padding=1, groups=1)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 3, 10, 12)).astype(np.float32)).to(torch.bfloat16)
    seen = []
    real = K.int8_conv

    def spy(x_, *a):
        seen.append((x_.dtype, a[-1]))
        return real(x_, *a)

    monkeypatch.setattr(M, "int8_conv", spy)
    got = q(x, 1)
    assert seen == [(torch.bfloat16, float(q.sin))]
    want = real(K.quantize_act(x, q.sin), q.weight, q.scale, q.bias, 2, 1, 1, 1, 0.05)
    assert torch.equal(got, want)


def _table_index(bits):
    """csrc/int8_conv.cu table_index: sign, exponent slot (0: e <= 110, 1-24: e = 111..134, 25: e = 135..254,
    26: e = 255), 7 mantissa bits."""
    e = (bits >> 7) & 0xFF
    slot = np.clip(e - 110, 0, 25) + ((e + 1) >> 8)
    return ((bits >> 15) * 27 + slot) * 128 + (bits & 0x7F)


def _requant_chain(act, sout):
    """The epilogue's tail on every bf16 value, as the plain version computes it: activation, requant."""
    y = torch.from_numpy(np.arange(65536, dtype=np.int32).astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    y = F.silu(y) if act == 1 else F.relu(y) if act == 2 else y
    return K.quantize_act(y, torch.tensor(sout, dtype=torch.float32)).numpy()


@pytest.mark.parametrize("act", [0, 1, 2])
def test_requant_table_index_covers_bf16_and_compresses_exactly(act):
    """The table's index map: one entry per bf16 value in slots 1-24 and 26; in slots 0 (|y| < 2^-16) and 25
    (2^8 <= |y| < inf) every y shares its (sign, mantissa) entry, which at yolo11's activation scales gives
    the same requant output (so the table is valid); at a tiny sout it does not (the kernel then falls back
    to the arithmetic)."""
    bits = np.arange(65536)
    idx = _table_index(bits)
    assert idx.min() == 0 and idx.max() == 2 * 27 * 128 - 1
    e = (bits >> 7) & 0xFF
    own = (e > 110) & (e < 135) | (e == 255)
    assert len(np.unique(idx[own])) == own.sum() and not np.isin(idx[~own], idx[own]).any()
    for sout, valid in ((0.0371, True), (0.004, True), (1.5, True), (1e-6, False)):
        q = _requant_chain(act, sout)
        uniform = all(len(np.unique(q[idx == i])) == 1 for i in np.unique(idx[~own]))
        assert uniform == valid, (sout, act)


# ---------------- gemm1x1: the 1x1 route's tile schedule, pipeline and shared-memory layout ----------------

BM, STEP, B_STAGES, RAW_STAGES, SMS, MAX_SMEM = 128, 64, 4, 2, 132, 232448  # csrc/int8_conv.cu's k1* constants
TAB_BYTES = 2 * 27 * 128


def _smem_1x1(bn, xes, oes, k_steps, a_sets, cout, whole=False):
    """smem_1x1: A slots, B ring, raw ring (float x), staged tile (rows of BN outputs of oes bytes), the table
    (whole: 64 KB, else compressed), scale and bias, barriers."""
    at = a_sets * k_steps * BM * STEP + B_STAGES * bn * STEP + (0 if xes == 1 else RAW_STAGES * BM * STEP * xes)
    at += BM * (bn * oes + 16) + (1 << 16 if whole else TAB_BYTES) + 8 * cout
    return -(-at // 8) * 8 + 8 * (2 * a_sets * k_steps + 2 * B_STAGES + 2 * RAW_STAGES)


def _plan_1x1(cin, cout, xes, oes=1):
    """plan() for a 1x1 stride-1 conv: (N tile, the sets of A slots that fit with the compressed table: (1,) or
    (1, 2)), or None where route 4 does not take it (the card's occupancy picks between the sets, and takes the
    whole table where it fits)."""
    if cin % 16 or cout % 8:
        return None
    bn = next(n for n in N_TILES if n == cout or (cout > n and cout % n == 0))
    k_steps = -(-cin // STEP)
    sets = tuple(a for a in ((1, 2) if xes == 1 else (1,)) if _smem_1x1(bn, xes, oes, k_steps, a, cout) <= MAX_SMEM)
    return (bn, sets) if sets else None


def _groups(m_tiles, n_tiles, slots):
    """plan()'s groups of N tiles: doubled while the M tiles alone would leave block slots idle."""
    g = 1
    while 2 * g <= n_tiles and n_tiles % (2 * g) == 0 and m_tiles * g < slots:
        g *= 2
    return g


def _chunks(cin, ks):
    return min(2, -(-(cin - ks * STEP) // CHUNK))


# (Cin, H, W, Cout) at 640 of the 1x1 convs that int8 serving feeds bf16 (a bf16 island's output: the Detect
# head's class branch of yolo11n, the C2PSA edges), from chip_smoke.py's per-conv tables of yolo11n and yolo11m
FLOAT_EDGES = {(256, 20, 20, 256), (80, 20, 20, 80), (80, 40, 40, 80), (80, 80, 80, 80), (512, 20, 20, 512),
               (256, 80, 80, 256), (256, 40, 40, 256)}


def _yolo_conv_shapes():
    """(B, Cin, H, W, Cout, k, stride, groups) of every conv of yolo11n and yolo11m at 640, batch 32 (a forward at
    64 scaled by 10)."""
    from yololite_tpu_torch.models.model import DetectionModel

    shapes = set()
    for name in ("yolo11n.yaml", "yolo11m.yaml"):
        model, seen = DetectionModel(name).eval(), []
        hooks = [m.conv.register_forward_hook(lambda mod, i, o: seen.append((i[0].shape, mod.weight.shape, mod.stride,
                                                                             mod.groups)))
                 for m in model.modules() if isinstance(m, M.Conv)]
        with torch.no_grad():
            model(torch.zeros(1, 3, 64, 64))
        for h in hooks:
            h.remove()
        for (_, cin, h, w), (cout, _, kh, _), stride, groups in seen:
            shapes.add((32, cin, 10 * h, 10 * w, cout, kh, stride[0], groups))
    return sorted(shapes)


def _yolo_1x1_shapes():
    """(B, Cin, H, W, Cout, x bytes) of every 1x1 conv of yolo11n and yolo11m at 640, batch 32 with an int8 x, and of
    the float edges with a bf16 x."""
    shapes = set()
    for b, cin, h, w, cout, k, stride, _ in _yolo_conv_shapes():
        if k == 1 and stride == 1:
            shapes.add((b, cin, h, w, cout, 1))
            if (cin, h, w, cout) in FLOAT_EDGES:
                shapes.add((b, cin, h, w, cout, 2))
    assert {s[1:5] for s in shapes if s[5] == 2} == FLOAT_EDGES
    return sorted(shapes)


class _Barriers:
    """mbarriers by their completed phases: a wait on parity P passes once the completed phases have the other
    parity; an arrival completes a phase at the barrier's count."""

    def __init__(self, counts):
        self.counts, self.done, self.arrivals = counts, {}, {}

    def passes(self, bar, parity):
        return (self.done.get(bar, 0) & 1) != parity

    def arrive(self, bar):
        self.arrivals[bar] = self.arrivals.get(bar, 0) + 1
        if self.arrivals[bar] == self.counts[bar[0]]:
            self.arrivals[bar] = 0
            self.done[bar] = self.done.get(bar, 0) + 1


def _run_to_end(producer, consumers, outs, bars):
    """Steps the producer and the consumers (generators that yield while a wait does not pass) until all end;
    raises on a deadlock (nothing moved for 16 rounds)."""
    alive, stalls = [producer, *consumers], 0
    while alive:
        before = (dict(bars.done), sum(len(o) for o in outs))
        for a in list(alive):
            try:
                next(a)
            except StopIteration:
                alive.remove(a)
        stalls = stalls + 1 if (dict(bars.done), sum(len(o) for o in outs)) == before else 0
        assert stalls < 16, "the pipeline deadlocked"


def _simulate_block(items, per_group, k_steps, quant, a_sets):
    """One block's producer warp and two consumer warpgroups over its work items ((M tile, first N tile) each),
    run step by step on the mbarriers' phase counts (a wait on parity P passes once the barrier's completed phases
    have the other parity); TMA lands at once. Returns the (M tile, N tile, K step) each consumer computed, in
    order; raises on a deadlock."""
    full = {}  # barrier -> completed phases
    arrivals = {}
    done = lambda bar: full.get(bar, 0)
    passes = lambda bar, parity: (done(bar) & 1) != parity

    def arrive(bar, count):
        arrivals[bar] = arrivals.get(bar, 0) + 1
        if arrivals[bar] == count:
            arrivals[bar] = 0
            full[bar] = done(bar) + 1

    def producer():
        bi = ri = 0
        for mi, (mt, nt0) in enumerate(items):
            for nt in range(nt0, nt0 + per_group):
                for ks in range(k_steps):
                    if nt == nt0 and not quant:
                        slot = (mi % a_sets) * k_steps + ks
                        while not passes(("a_empty", slot), ((mi // a_sets) & 1) ^ 1):
                            yield
                        arrive(("a_full", slot), 1)
                    elif nt == nt0:
                        while not passes(("raw_empty", ri % RAW_STAGES), ((ri // RAW_STAGES) & 1) ^ 1):
                            yield
                        arrive(("raw_full", ri % RAW_STAGES), 1)
                        ri += 1
                    while not passes(("b_empty", bi % B_STAGES), ((bi // B_STAGES) & 1) ^ 1):
                        yield
                    arrive(("b_full", bi % B_STAGES), 1)
                    bi += 1
                    yield

    def consumer(out):
        bi = ri = 0
        for mi, (mt, nt0) in enumerate(items):
            aset = 0 if quant else mi % a_sets
            for nt in range(nt0, nt0 + per_group):
                last = nt == nt0 + per_group - 1
                for ks in range(k_steps):
                    if nt == nt0 and quant:
                        while not passes(("raw_full", ri % RAW_STAGES), (ri // RAW_STAGES) & 1):
                            yield
                        arrive(("raw_empty", ri % RAW_STAGES), 2)
                        ri += 1
                    elif nt == nt0:
                        while not passes(("a_full", aset * k_steps + ks), (mi // a_sets) & 1):
                            yield
                    while not passes(("b_full", bi % B_STAGES), (bi // B_STAGES) & 1):
                        yield
                    out.append((mt, nt, ks))
                    if ks > 0:  # the step before is done: its slots go back
                        arrive(("b_empty", (bi - 1) % B_STAGES), 2)
                        if last and not quant:
                            arrive(("a_empty", aset * k_steps + ks - 1), 2)
                    bi += 1
                    yield
                arrive(("b_empty", (bi - 1) % B_STAGES), 2)
                if last and not quant:
                    arrive(("a_empty", aset * k_steps + k_steps - 1), 2)

    outs = [[], []]
    alive = [producer(), consumer(outs[0]), consumer(outs[1])]
    stalls = 0
    while alive:
        before = (dict(full), len(outs[0]) + len(outs[1]))
        for a in list(alive):
            try:
                next(a)
            except StopIteration:
                alive.remove(a)
        stalls = stalls + 1 if (dict(full), len(outs[0]) + len(outs[1])) == before else 0
        assert stalls < 16, "the pipeline deadlocked"
    assert outs[0] == outs[1]
    return outs[0]


@pytest.mark.parametrize("xes", [1, 2], ids=["int8", "bf16"])
def test_1x1_schedule_covers_every_tile_once(xes):
    """On every 1x1 shape of yolo11n and yolo11m at 640, batch 32: route 4 takes it (Cin a multiple of 16, its
    shared memory fits); for every grouping of the N tiles plan() can pick and every grid of 1 or 2 blocks an SM,
    the persistent blocks' work items ((M tile, group of N tiles)) take every (M tile, N tile, K step) once, and
    the steps' 32-byte chunks cover [0, Cin) with the K tail's box reading zeros past it; the M tiles cover every
    output row (the tail's rows past M zero-filled, not stored). One block's producer and consumers, run on the
    barriers' phases with one or two sets of A slots, take the same steps in the same order without a deadlock."""
    shapes = [s for s in _yolo_1x1_shapes() if s[5] == xes]
    assert len(shapes) >= (20 if xes == 1 else 7)
    for b, cin, h, w, cout, _ in shapes:
        plan = _plan_1x1(cin, cout, xes)
        assert plan is not None, (cin, cout)
        bn, sets = plan
        m = b * h * w
        m_tiles, n_tiles, k_steps = -(-m // BM), cout // bn, -(-cin // STEP)
        assert m_tiles * BM - m < BM
        kbytes = np.zeros(-(-cin // CHUNK) * CHUNK, np.int64)
        for ks in range(k_steps):
            for c in range(_chunks(cin, ks)):
                kbytes[ks * STEP + c * CHUNK:ks * STEP + (c + 1) * CHUNK] += 1
        assert (kbytes == 1).all() and len(kbytes) - cin < CHUNK
        for blocks in (1, 2):
            g = _groups(m_tiles, n_tiles, SMS * blocks)
            per = n_tiles // g
            items = m_tiles * g
            grid = min(items, SMS * blocks)
            seen = np.zeros((m_tiles, n_tiles), np.int64)
            for blk in {0, grid - 1}:  # the first and last blocks' items, then every item at once
                assert all(w_ % grid == blk for w_ in range(blk, items, grid))
            wi = np.arange(items)
            for nt in range(per):
                np.add.at(seen, (wi // g, (wi % g) * per + nt), 1)
            assert (seen == 1).all()  # every (M tile, N tile) once; each runs all its K steps
            for sets_ in sets:
                mine = [(w_ // g, (w_ % g) * per) for w_ in range(0, items, grid)][:3]
                order = _simulate_block(mine, per, k_steps, xes > 1, sets_)
                assert order == [(mt, nt, ks) for mt, nt0 in mine for nt in range(nt0, nt0 + per)
                                 for ks in range(k_steps)]


def _tma_box(src, r0, c0, rows, cols):
    """A TMA box of a row-major matrix: rows x cols from (r0, c0), zero past its edges."""
    out = np.zeros((rows, cols), src.dtype)
    part = src[r0:r0 + rows, c0:c0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _tma_box_pitched(flat, offset, rows_all, cols_all, pitch, r0, c0, rows, cols):
    """A 2-D TMA box of a (rows_all, cols_all) matrix of rows `pitch` elements apart in `flat` from `offset` (the
    A map of a channel-split view: pixels, Cin, pitch), zero past the map's dimensions."""
    out = np.zeros((rows, cols), flat.dtype)
    for r in range(rows):
        for c in range(cols):
            if r0 + r < rows_all and c0 + c < cols_all:
                out[r, c] = flat[offset + (r0 + r) * pitch + c0 + c]
    return out


def _swizzle32_write(slot, base, box):
    """A TMA box of 32-byte rows written with CU_TENSOR_MAP_SWIZZLE_32B: row r's 16-byte halves at r * 32, swapped
    where address bit 7 is set (the wgmma descriptors' 32-byte swizzle)."""
    for r in range(box.shape[0]):
        for k in range(CHUNK):
            slot[base + _swizzled_offset(r, k)] = box[r, k].view(np.uint8)


@pytest.mark.parametrize("case", [(2, 48, 5, 7, 8, 1, 48), (3, 64, 7, 9, 256, 1, 64), (1, 96, 6, 6, 80, 2, 96),
                                  (1, 16, 4, 4, 24, 4, 16), (2, 64, 5, 6, 32, 1, 128)],
                         ids=["cin48-k-tail", "cout256-m-tail", "bf16-x", "fp32-x-cout24", "split-view-pitch128"])
def test_1x1_layout_model_matches_conv(case):
    """A numpy model of route 4's data path on one M tile after another: A's 32-byte chunks by TMA (rows `pitch`
    elements apart: a channel-split view's second half read in place) into the swizzled slot (an int8 x), or a float
    x's raw box into the staging slot and each warpgroup's 64 rows quantized into the A slot (8 elements a write, at
    swizzled_offset); B's chunks of each N tile; each warpgroup's wgmma reading its 64 rows through the descriptors
    (chunk c at c * 4,096, warpgroup w at w * 2,048; B chunk c at c * BN * 32). The int32 sums equal the reference
    conv."""
    b, cin, h, w, cout, xes, pitch = case
    rng = np.random.default_rng(cin + cout)
    bn, _ = _plan_1x1(cin, cout, xes)
    m = b * h * w
    wq = rng.integers(-127, 128, (cout, 1, 1, cin)).astype(np.int8)
    sin = np.float32(1 / 64)
    offset = pitch - cin  # the view is the last Cin channels of each pixel
    if xes == 1:
        full = rng.integers(-127, 128, (b, h, w, pitch)).astype(np.int8)
    else:
        full = rng.uniform(-0.5, 2.5, (b, h, w, pitch)).astype(np.float32)
        if xes == 2:
            full = torch.from_numpy(full).to(torch.bfloat16).float().numpy()
    x = full[..., offset:]
    xq = x if xes == 1 else K.quantize_act(torch.from_numpy(np.ascontiguousarray(x)), torch.tensor(sin)).numpy()
    flat, b_mat = full.reshape(-1), wq.reshape(cout, cin)
    got = np.zeros((m, cout), np.int64)
    for mt in range(-(-m // BM)):
        for nt in range(cout // bn):
            acc = np.zeros((BM, bn), np.int64)
            for ks in range(-(-cin // STEP)):
                sa = np.zeros(BM * STEP, np.uint8)
                if xes == 1:
                    for c in range(_chunks(cin, ks)):
                        box = _tma_box_pitched(flat, offset, m, cin, pitch, mt * BM, ks * STEP + c * CHUNK, BM, CHUNK)
                        _swizzle32_write(sa, c * BM * CHUNK, box)
                else:
                    raw = _tma_box_pitched(flat, offset, m, cin, pitch, mt * BM, ks * STEP, BM, STEP)  # staging slot
                    q = K.quantize_act(torch.from_numpy(raw), torch.tensor(sin)).numpy()
                    for r in range(BM):
                        for kg in range(8):
                            for e in range(8):
                                at = (kg >> 2) * BM * CHUNK + _swizzled_offset(r, (kg & 3) * 8 + e)
                                sa[at] = q[r, kg * 8 + e].view(np.uint8)
                sb = np.zeros(bn * STEP, np.uint8)
                for c in range(_chunks(cin, ks)):
                    _swizzle32_write(sb, c * bn * CHUNK, _tma_box(b_mat, nt * bn, ks * STEP + c * CHUNK, bn, CHUNK))
                for wg in range(2):
                    for c in range(_chunks(cin, ks)):
                        ar = _descriptor_read(sa, c * BM * CHUNK + wg * 64 * CHUNK, 64).view(np.int8).astype(np.int64)
                        br = _descriptor_read(sb, c * bn * CHUNK, bn).view(np.int8).astype(np.int64)
                        acc[wg * 64:(wg + 1) * 64] += ar @ br.T
            rows = min(BM, m - mt * BM)
            got[mt * BM:mt * BM + rows, nt * bn:(nt + 1) * bn] = acc[:rows]
    np.testing.assert_array_equal(got, xq.reshape(m, cin).astype(np.int64) @ b_mat.astype(np.int64).T)


def test_int8_conv_on_a_split_view_equals_its_copy():
    """On the CPU the op takes a channel-split view (the second half of a channels-last tensor, as C3k2 splits it)
    as it is: the same output as on the view's contiguous copy, bit for bit, no copy counted; `x_pitch` reads its
    pixel pitch (the whole tensor's channels) and rejects an NCHW layout; opcheck passes on the strided input."""
    rng = np.random.default_rng(12)
    full = torch.from_numpy(rng.integers(-127, 128, (2, 64, 9, 7)).astype(np.int8)).contiguous(
        memory_format=torch.channels_last)
    a, x = full.split((32, 32), 1)
    assert K.x_pitch(x) == 64 and K.x_pitch(a) == 64 and K.x_pitch(full) == 64 and K.x_pitch(x.contiguous()) is None
    for k, stride in ((3, 1), (3, 2), (1, 1)):
        w, scale, bias = _conv_args(rng, 32, 24, k)
        copies = K.int8_conv.copies
        got = K.int8_conv(x, w, scale, bias, stride, k // 2, 1, 1, 0.05)
        want = K.int8_conv(x.contiguous(memory_format=torch.channels_last), w, scale, bias, stride, k // 2, 1, 1, 0.05)
        assert K.int8_conv.copies == copies and torch.equal(got, want)
        torch.library.opcheck(torch.ops.yololite_tpu_torch.int8_conv.default,
                              (x, w, scale, bias, stride, k // 2, 1, 1, 0.05, 0.0))


def test_export_of_a_split_view_equals_the_in_process_run(tmp_path):
    """A module that splits a channels-last int8 tensor and hands the second half to the op, as C3k2 does: its
    torch.export graph records the op on the strided view (the fake gives the output's shape and layout), and the
    program reloaded from disk gives the in-process output bit for bit, int8 and bf16 out."""
    rng = np.random.default_rng(21)
    w, scale, bias = _conv_args(rng, 16, 24, 3)

    class Split(torch.nn.Module):
        def __init__(self, sout):
            super().__init__()
            self.register_buffer("w", w)
            self.register_buffer("scale", scale)
            self.register_buffer("bias", bias)
            self.sout = sout

        def forward(self, x):
            _, b = x.split((16, 16), 1)
            return K.int8_conv(b, self.w, self.scale, self.bias, 1, 1, 1, 1, self.sout)

    x = torch.from_numpy(rng.integers(-127, 128, (2, 32, 9, 7)).astype(np.int8)).contiguous(
        memory_format=torch.channels_last)
    for sout in (0.05, 0.0):
        m = Split(sout)
        want = m(x)
        path = tmp_path / f"split_{sout}.pt2"
        torch.export.save(torch.export.export(m, (x,)), str(path))
        got = torch.export.load(str(path)).module()(x)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert torch.equal(want, K.int8_conv(x[:, 16:].contiguous(memory_format=torch.channels_last), w, scale, bias,
                                             1, 1, 1, 1, sout))
