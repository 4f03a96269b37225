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


def _gemm_model(x, w, stride, pad, bn, wg, granule, chunks=2):
    """The gemm route on int8 NHWC x and OHWI w, as the kernel indexes it: int32 NHWC accumulators.

    K = taps x Cin is walked flat (k = (ky * kw + kx) * Cin + c) in steps of `chunks` chunks of 32; each
    16-byte K half (or 8-byte piece) finds its tap and channel from k, and a step runs one wgmma per chunk
    that has K indices."""
    b, h, wi, cin = x.shape
    cout, kh, kw, _ = w.shape
    ho, wo = (h + 2 * pad - kh) // stride + 1, (wi + 2 * pad - kw) // stride + 1
    m_all, bm, threads = b * ho * wo, 64 * wg, 128 * wg
    K = kh * kw * cin
    steps = -(-K // (chunks * CHUNK))
    xf, wf = x.reshape(-1), w.reshape(-1)
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
        xrow = ((bi * h + iy0) * wi + ix0) * cin

        def x_offset(k):  # per thread: the x index of K index k, or -1 for a zero
            tap = _umulhi_div(k, cin)
            c = k - tap * cin
            ky = _umulhi_div(tap, kw)
            kx = tap - ky * kw
            iy, ix = iy0 + ky, ix0 + kx
            ok = row_ok & (k < K) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wi)
            return np.where(ok, xrow + (ky * wi + kx) * cin + c, -1)

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
