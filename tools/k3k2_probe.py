#!/usr/bin/env python3
"""K3 and K2 on the card at a glance: build them, hold them to their plain versions on random maps and frames, and
time yolo11n's stem and forward (B 32 at 640) on either input layout K2 can write.

    python3 tools/k3k2_probe.py

Prints one line per K3 scene (vals, bidx, cls and valid bit for bit; the boxes' largest relative difference), the
sigmoid's bits against torch.sigmoid over every bf16 logit and an fp32 sweep, one line per K2 check, and for fp32
and bf16 the stem's, the forward's, K3's and K2's milliseconds (back-to-back calls between CUDA events) with an
NCHW-contiguous and a channels-last input, each twice.
"""
import sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo root
import numpy as np
import torch
from yololite_tpu_torch.ops import cuda_build, kernels as K

t0 = time.time()
libs = cuda_build.build(["select_decode", "letterbox"])
print("build", time.time() - t0, flush=True)
for n, p in libs.items():
    print(n, " | ".join(l.strip() for l in p.with_suffix(".log").read_text().splitlines() if l.strip())[:3000])

def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

def maps(rng, b, shapes, nc, dtype, nchw, scale=3.0, bias=-4.0, nan=False):
    out = []
    for h, w in shapes:
        a = rng.standard_normal((b, 64 + nc, h, w)).astype(np.float32)
        a[:, 64:] = a[:, 64:] * scale + bias
        if nan:
            a[0, 64 + 3, 1, 1] = np.nan
            a[0, 5, 2, 2] = np.nan
        t = torch.from_numpy(a).cuda().to(dtype)
        out.append(t.permute(0, 2, 3, 1) if nchw else t.permute(0, 2, 3, 1).contiguous())
    return out

fails = 0
def check(name, feats, kw):
    global fails
    args = (feats, [8, 16, 32][:len(feats)], kw.pop("nc"), 16, kw.pop("conf"), kw.pop("k"), kw.pop("mask", None),
            kw.pop("half", False), kw.pop("ml", False), kw.pop("agn", False))
    got = K.select_decode(*args)
    want = K.select_decode_plain(*args)
    torch.cuda.synchronize()
    ok = [same_bits(g, w) for g, w in zip(got, want)]
    bx = got[3]; wb = want[3]
    fin = torch.isfinite(wb)
    rel = ((bx - wb).abs() / wb.abs().clamp_min(1e-30))[fin].max().item() if fin.any() else 0.0
    nanok = torch.equal(torch.isnan(bx), torch.isnan(wb))
    exact = ok[:3] + [ok[5]]
    if not all(exact) or not nanok or rel > 1e-6:
        fails += 1
        d = (got[1] != want[1]).nonzero()
        print("FAIL", name, ok, "rel", rel, "nan", nanok, "first diff", d[:3].tolist(), flush=True)
        if len(d):
            b0, r0 = d[0].tolist()
            print("  got", got[0][b0, r0-2:r0+3].tolist(), got[1][b0, r0-2:r0+3].tolist())
            print("  want", want[0][b0, r0-2:r0+3].tolist(), want[1][b0, r0-2:r0+3].tolist())
    else:
        print("ok", name, "boxes bit-equal" if ok[3] and ok[4] else f"boxes rel {rel:.3g}", flush=True)

rng = np.random.default_rng(0)
S640 = ((80, 80), (40, 40), (20, 20))
RECT = ((48, 80), (24, 40), (12, 20))
for dtype in (torch.float32, torch.bfloat16):
    for nchw in (True, False):
        for b, k, ml in ((32, 512, False), (16, 8192, True), (1, 300, False), (2, 1, True), (16, 8192, False), (1, 9000, True)):
            for half in ((False, True) if dtype == torch.bfloat16 else (False,)):
                f = maps(rng, b, S640 if b != 2 else RECT, 80, dtype, nchw)
                check(f"{dtype} nchw={nchw} B{b} K{k} ml={ml} half={half}", f, dict(nc=80, conf=1e-7 if ml else 0.0123, k=k, half=half, ml=ml))
# scenes: all gated out, all equal, K >= N, NaN, class mask, agnostic, big K global sort
f = maps(rng, 4, RECT, 80, torch.float32, True)
check("all gated", f, dict(nc=80, conf=0.9999, k=1000, ml=True))
f = maps(rng, 4, RECT, 80, torch.float32, True, scale=0.0, bias=-2.0)
check("all equal ml", f, dict(nc=80, conf=0.01, k=5000, ml=True))
check("all equal single", f, dict(nc=80, conf=0.01, k=700, ml=False))
f = maps(rng, 2, ((8, 10), (4, 5), (2, 3)), 5, torch.float32, True)
check("K>=N ml", f, dict(nc=5, conf=0.3, k=100000, ml=True))
check("K>=N single", f, dict(nc=5, conf=0.3, k=100000, ml=False))
f = maps(rng, 4, RECT, 80, torch.bfloat16, True, nan=True)
check("nan bf16 half", f, dict(nc=80, conf=0.01, k=512, half=True))
check("nan ml", f, dict(nc=80, conf=0.01, k=8192, ml=True))
mask = torch.from_numpy(np.arange(80) % 3 == 0).cuda()
check("mask", f, dict(nc=80, conf=0.01, k=512, mask=mask, agn=True))
f = maps(rng, 2, S640, 80, torch.float32, True)
check("K 40000 global sort", f, dict(nc=80, conf=1e-7, k=40000, ml=True))
check("K 16384", f, dict(nc=80, conf=1e-7, k=16384, ml=True))
check("K 16385", f, dict(nc=80, conf=1e-7, k=16385, ml=True))
# sigmoid bits: every bf16 value, K = N, all pass
allbf = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
allbf = allbf[~torch.isnan(allbf)]
n = allbf.numel() // 1 * 1
cl = allbf[: (n // 64) * 64].reshape(1, 64, 1, -1)  # nc = 64 classes... use ml over one level
for half in (False, True):
    t = cl.cuda()
    feat = torch.cat([torch.zeros(1, 64, 1, t.shape[-1], device="cuda", dtype=torch.bfloat16), t], 1).permute(0, 2, 3, 1)
    got = K.select_decode([feat], [8], 64, 16, -2.0, 1 << 30, None, half, True, False)
    s = torch.sigmoid(t if half else t.float()).permute(0, 2, 3, 1).reshape(1, -1).float()
    want = s[0][got[1][0] * 64 + got[2][0].long()]
    print("sigmoid bf16 half", half, "bit-equal", torch.equal(got[0][0].view(torch.int32), want.view(torch.int32)), flush=True)
x = torch.linspace(-30, 30, 64 * 4001, device="cuda").reshape(1, 64, 1, -1)
feat = torch.cat([torch.zeros(1, 64, 1, x.shape[-1], device="cuda"), x], 1).permute(0, 2, 3, 1)
got = K.select_decode([feat], [8], 64, 16, -2.0, 1 << 30, None, False, True, False)
s = torch.sigmoid(x).permute(0, 2, 3, 1).reshape(-1)
print("sigmoid fp32 bit-equal", torch.equal(got[0][0], s[got[1][0] * 64 + got[2][0].long()]), flush=True)

# K2
for shape, s in (((480, 640), 640), ((720, 1280), 640), ((333, 517), 320), ((100, 120), 320), ((640, 640), 640)):
    im = torch.from_numpy(rng.integers(0, 256, (4, *shape, 3), dtype=np.uint8)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        for bgr in (False, True):
            for cl in (False, True):
                got = K.device_letterbox(im, s, dtype, bgr=bgr, channels_last=cl)
                want = K.device_letterbox_plain(im, s, dtype, bgr)
                err = (got.float() - want.float()).abs().max().item()
                print("K2", shape, s, dtype, bgr, cl, "bit-equal" if same_bits(got.contiguous(), want) else f"err {err:.3g}",
                      "layout ok" if (got.permute(0, 3, 1, 2).is_contiguous() if not cl else got.is_contiguous()) else "LAYOUT", flush=True)
print("fails", fails)

# forward layout timing (yolo11n fused, B 32, 640)
from yololite_tpu_torch import YOLOLite
from yololite_tpu_torch.engine.predictor import inference_net, forward_nhwc, fp32_convs
model = YOLOLite("yolo11n.yaml").model
def ms(fn, it=20):
    for _ in range(3): fn()
    torch.cuda.synchronize(); a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(it): fn()
    b.record(); torch.cuda.synchronize(); return a.elapsed_time(b) / it
for half in (False, True):
    net = inference_net(model, torch.device("cuda"), half)
    im = torch.from_numpy(rng.integers(0, 256, (32, 480, 640, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode(), fp32_convs(im.device):
        for cl in (True, False, True, False):
            x = K.device_letterbox(im, 640, torch.bfloat16 if half else torch.float32, bgr=True, channels_last=cl)
            stem = list(net.modules())[1] if not hasattr(net, "model") else net.model[0]
            t_stem = ms(lambda: stem(x.permute(0, 3, 1, 2)))
            t_fw = ms(lambda: forward_nhwc(net, x))
            feats = forward_nhwc(net, x)
            t_k3 = ms(lambda: K.select_decode(feats, [8, 16, 32], 80, 16, 1e-7, 512, None, half, False, False))
            t_k3p = ms(lambda: K.select_decode_plain(feats, [8, 16, 32], 80, 16, 1e-7, 512, None, half, False, False), 5)
            t_k2 = ms(lambda: K.device_letterbox(im, 640, torch.bfloat16 if half else torch.float32, bgr=True, channels_last=cl))
            print(f"half={half} channels_last={cl}: stem {t_stem:.3f} ms, forward {t_fw:.3f} ms, K3 {t_k3:.4f} plain {t_k3p:.3f}, K2 {t_k2:.4f}; maps stride {feats[0].stride()}", flush=True)
