"""Which part of a kernel sets its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ablation

Each variant of a CUDA source removes or replaces one part of its
kernel; all are built from this checkout into `build/ablation/` and
timed at the main path's shapes (device time of the kernel from
`torch.profiler`, 10 launches after one).  A variant that removes a
part computes a wrong result: only its time means anything, and the
kernel's own result is checked; a variant that changes how the same
function is computed (the flash stage count and k-steps) is checked
too.  A variant whose text no longer matches the source fails with its
name.

* `csrc/ssd_scan.cu`'s tensor-core kernel at mamba2-780m and zamba2-7b
  width (16 chunks of 256), with 2 heads an item and with 1: no stores
  of Y; no column data (dacs_j, dt_j never loaded); 2^x replaced by a
  subtraction; M replaced by S; no M·X product; no C·Bᵀ product.
* `csrc/ssd_scan.cu`'s SIMT kernels at the same widths in f32, with
  their `simt_heads` head block: no M·X product; no X loads; no C·Bᵀ
  product (the first pass's); M replaced by S (no 2^x, no masks).
* `csrc/fleet_hist.cu` on one job's grid (1,563 x 2,880) and on 64 of
  them in one call, 128 uniform bins, OFU spread over them: lanes that
  hit one cell combined by `__match_any_sync` before the shared atomic;
  no shared atomics; no binning either (loads and sums only).
* `csrc/flash_attention.cu`'s tensor-core kernel at phi-3-vision-4.2b,
  zamba2-7b and nemotron-4-340b width (S 4,096, causal, bf16): the
  hd-192 ring with 2 stages instead of 3; S = Q·Kᵀ over every k-step of
  the padded tile, the zero columns past hd 96 or 112 included; O += P·V
  at n64 for hd 96 and 112, dropping the padded box's 64 columns (twice
  what an n96 or n112 product would save).
"""
from __future__ import annotations

import ctypes
import math
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build, fleet_hist, ops, ssd_scan
from repro_torch.kernels.ref import ref_attention, ref_ssd_intra

OUT = _build.BUILD_DIR.parent / "ablation"

_SSD_M = ("exp2_ftz(ai - cj.x)", "exp2_ftz(ai - cj.z)")
SSD_VARIANTS = {
    "no Y stores": [("""        *reinterpret_cast<uint4*>(
            y + ((""", """        if (v.x == 0x7fffffffu) *reinterpret_cast<uint4*>(
            y + ((""")],
    "no column data": [(
        "for (int e = ct; e < HB * q_pad; e += kColThreads) {",
        "for (int e = ct; e < 0; e += kColThreads) {")],
    "no 2^x": [(_SSD_M[0], "(ai - cj.x)"), (_SSD_M[1], "(ai - cj.z)")],
    "M = S": [("""    const float4 cj = *reinterpret_cast<const float4*>(ci + jl);
    float m0 = sacc[i] * exp2_ftz(ai - cj.x) * cj.y;
    float m1 = sacc[i + 1] * exp2_ftz(ai - cj.z) * cj.w;""",
               "    float m0 = sacc[i], m1 = sacc[i + 1];")],
    "no M.X": [("""          if constexpr (HD == 128) wgmma_rs_n128(yacc[hh], pa[hh % 2][kk], dx);
          else wgmma_rs_n64(yacc[hh], pa[hh % 2][kk], dx);""",
                """          if (dx == 1ull)
            yacc[hh][0] += __uint_as_float(pa[hh % 2][kk][0]);""")],
    "no C.B^T": [("""        wgmma_ss_n128<0>(sacc, smem_desc(ca + off, 16, 1024),
                         smem_desc(sb + off, 16, 1024), kk > 0);""",
                  """        if (kk == 0)
          for (int q = 0; q < kTcRows / 2; ++q) sacc[q] = 1.f + off;""")],
}
SIMT_SSD_VARIANTS = {
    "no M.X": [("""          for (int jj = 0; jj < kHalf; jj += 4) {
            float mr[8][4];""", """          for (int jj = 0; jj < 0; jj += 4) {
            float mr[8][4];""")],
    "no X loads": [(
        "    load_rows(Xq + (n % kRing) * kHalf * kXW, kXW, src, x_stride,",
        "    if (n < 0)\n    load_rows(Xq + (n % kRing) * kHalf * kXW, kXW, "
        "src, x_stride,")],
    "no C.B^T": [("""    for (int d = 0; d < w4; d += 4) {
      float br[4][4];""", """    for (int d = 0; d < 0; d += 4) {
      float br[4][4];""")],
    "M = S": [("""            if (!(diag && c0 + u > r) && j0 + c0 + u < Q)
              mv[u] = round_to<T>(sv[u] * ex2_sfu((ai - aj[u]) * kLog2e)
                                  * dtj[u]);""", "            mv[u] = sv[u];")],
}
_HIST_ADD = "          atomicAdd(&s_hist[key0[u] + k], 1);"
HIST_VARIANTS = {
    "__match_any_sync": [(_HIST_ADD, """          const int key = key0[u] + k;
          const unsigned same = __match_any_sync(__activemask(), key);
          if ((threadIdx.x % 32) == __ffs(same) - 1)
            atomicAdd(&s_hist[key], __popc(same));""")],
    "no shared atomics": [(_HIST_ADD, "          acc[u] += k;")],
    "loads and sums only": [(
        """          const int k = find_bin(v[a][u], s_edges, bins, e0, inv_w);
          atomicAdd(&s_hist[key0[u] + k], 1);""", "")],
}


FLASH_VARIANTS = {
    "hd 192: 2 stages": [("constexpr int kStages192 = 3;",
                          "constexpr int kStages192 = 2;")],
    "every padded k-step": [(
        "for (int kk = 0; kk < (HD + 15) / 16; ++kk) {",
        "for (int kk = 0; kk < P::kPad / 16; ++kk) {")],
    "P.V at n64 past hd 64": [(
        "else if constexpr (P::kPad == 128) wgmma_rs_n128(o, pa[kk], dv);",
        """else if constexpr (HD == 128) wgmma_rs_n128(o, pa[kk], dv);
        else if constexpr (P::kPad == 128)
          wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(o), pa[kk], dv);""")],
}
#: flash variants that compute a wrong result on purpose (timed only)
FLASH_WRONG = ("P.V at n64 past hd 64",)


def _variants(name: str, subs: dict, tag: str = "") -> dict:
    """{variant: path of its source}, the kernel's own first; `tag` keeps
    two variant sets of one source apart."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    out = {"kernel": _build.CSRC / f"{name}.cu"}
    for i, (what, pairs) in enumerate(subs.items()):
        text = src
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}.cu variant {what!r}: its text "
                                   "is no longer in the source")
            text = text.replace(old, new)
        path = OUT / f"{name}{tag}_v{i}.cu"
        path.write_text(text)
        out[what] = path
    return out


def _build_all(sources: dict) -> dict:
    """{key: ctypes library}, all nvcc processes at once."""
    procs = {}
    for key, src in sources.items():
        lib = OUT / f"{key[0]}_{src.stem}.so"
        procs[key] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def device_ms(fn, kernel: str, n: int = 10) -> float:
    """Mean device time a call of fn, over n calls after one, of the
    kernels whose names hold `kernel` (summed where a call launches
    several); nan where the profiler saw none in two tries."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if kernel in e.key]
        if ev:
            return sum(e.self_device_time_total for e in ev) / n / 1e3
    return float("nan")


def ssd(libs: dict) -> None:
    dev = torch.device("cuda", 0)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for model, (nh, g, ds) in (("mamba2-780m", (48, 1, 128)),
                               ("zamba2-7b", (112, 2, 64))):
        B, S, Q, hd = 1, 4096, 256, 64
        gen = torch.Generator(device=dev).manual_seed(1)
        x = (torch.randn((B, S, nh, hd), generator=gen, device=dev) * 0.5) \
            .bfloat16()
        dt = torch.empty((B, S, nh), device=dev).uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        A = -torch.empty(nh, device=dev).uniform_(1.0, 16.0, generator=gen)
        bm, cm = ((torch.randn((B, S, g, ds), generator=gen, device=dev)
                   * 0.3).bfloat16() for _ in range(2))
        inputs = ops.ssd_intra_inputs(x, dt, A, bm, cm, chunk=Q)
        BC = inputs[0].shape[0]
        want = ref_ssd_intra(*inputs).float()
        row = []
        for what, lib in libs.items():
            fn = lib.ssd_intra_bf16_wgmma
            fn.argtypes, fn.restype = [p] * 6 + [i32] * 8 + [p], i32
            for hb in (2, 1):
                y = torch.zeros_like(inputs[0])
                args = (*(t.data_ptr() for t in inputs), y.data_ptr(), BC, Q,
                        nh, hd, g, ds, hb, dev.index,
                        torch.cuda.current_stream().cuda_stream)
                if fn(*args):
                    raise RuntimeError(f"ssd {what}: launch failed")
                if what == "kernel":
                    torch.testing.assert_close(y.float(), want, rtol=5e-2,
                                               atol=5e-2)
                row.append(f"{what} (HB {hb}) "
                           f"{device_ms(lambda: fn(*args), 'ssd_bf16'):.4f}")
        print(f"ssd_intra {model} ({BC}, {Q}, {nh}, {hd}, g {g}, ds {ds}), "
              "device ms: " + "; ".join(row))


def ssd_simt(libs: dict) -> None:
    dev = torch.device("cuda", 0)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for model, (nh, g, ds) in (("mamba2-780m", (48, 1, 128)),
                               ("zamba2-7b", (112, 2, 64))):
        B, S, Q, hd = 1, 4096, 256, 64
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((B, S, nh, hd), generator=gen, device=dev) * 0.5
        dt = torch.empty((B, S, nh), device=dev).uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        A = -torch.empty(nh, device=dev).uniform_(1.0, 16.0, generator=gen)
        bm, cm = (torch.randn((B, S, g, ds), generator=gen, device=dev) * 0.3
                  for _ in range(2))
        inputs = ops.ssd_intra_inputs(x, dt, A, bm, cm, chunk=Q)
        BC, hb = inputs[0].shape[0], ssd_scan.simt_heads(hd)
        cb = torch.empty(ssd_scan.simt_scratch(BC, Q, g), device=dev)
        row = []
        for what, lib in libs.items():
            fn = lib.ssd_intra
            fn.argtypes, fn.restype = [i32] + [p] * 7 + [i32] * 8 + [p], i32
            y = torch.zeros_like(inputs[0])
            args = (0, *(t.data_ptr() for t in inputs), y.data_ptr(),
                    cb.data_ptr(), BC, Q, nh, hd, g, ds, hb, dev.index,
                    torch.cuda.current_stream().cuda_stream)
            if fn(*args):
                raise RuntimeError(f"ssd simt {what}: launch failed")
            if what == "kernel":
                torch.testing.assert_close(y, ref_ssd_intra(*inputs),
                                           rtol=1e-3, atol=1e-3)
            # both passes: ssd_cb_kernel and ssd_intra_kernel
            row.append(f"{what} "
                       f"{device_ms(lambda: fn(*args), 'ssd_'):.4f}")
        print(f"ssd_intra SIMT {model} ({BC}, {Q}, {nh}, {hd}, g {g}, "
              f"ds {ds}), f32, {hb} heads a block, device ms: "
              + "; ".join(row))


def hist(libs: dict) -> None:
    dev = torch.device("cuda", 0)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    edges = np.linspace(0.0, 1.1, 129)
    edges_t = torch.from_numpy(edges.astype(np.float32)).to(dev)
    S, nb, inv_fmax = 2880, 288, 1 / 1980.0
    col = np.arange(S) // 10
    plan, n_slots = fleet_hist.plan(col, nb)
    plan_t = torch.from_numpy(plan).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, D in (("one job's grid", 1563), ("64 grids in one call",
                                               64 * 1563)):
        tpa = torch.rand((D, S), generator=gen, device=dev) * 0.5 + 0.2
        clk = 1900.0 + torch.rand((D, S), generator=gen, device=dev) * 80
        want, _ = fleet_hist.bucket_hist_torch(
            tpa, clk, inv_fmax=inv_fmax, edges=edges, col_bucket=col,
            n_buckets=nb)
        row = []
        for what, lib in libs.items():
            fn = lib.fleet_hist
            fn.argtypes = [p, p, i64, i64, i64, p, i32, p, i32,
                           ctypes.c_float, p, p, i32, p]
            fn.restype = i32
            h = torch.zeros((nb, 128), dtype=torch.int32, device=dev)
            s = torch.zeros(nb, dtype=torch.float64, device=dev)
            args = (tpa.data_ptr(), clk.data_ptr(), D, S,
                    fleet_hist.rows_per_block(D, S), plan_t.data_ptr(),
                    n_slots, edges_t.data_ptr(), 128,
                    float(np.float32(inv_fmax)), h.data_ptr(), s.data_ptr(),
                    dev.index, torch.cuda.current_stream().cuda_stream)
            if fn(*args):
                raise RuntimeError(f"fleet_hist {what}: launch failed")
            if what in ("kernel", "__match_any_sync"):
                torch.cuda.synchronize()
                if not torch.equal(h.long(), want):
                    raise RuntimeError(f"fleet_hist {what}: wrong counts")
            row.append(f"{what} "
                       f"{device_ms(lambda: fn(*args), 'fleet_hist'):.4f}")
        print(f"fleet_hist {name} ({D} x {S}), device ms: " + "; ".join(row))


def flash(libs: dict) -> None:
    dev = torch.device("cuda", 0)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for model, (H, KV, hd) in (("phi-3-vision-4.2b", (32, 32, 96)),
                               ("zamba2-7b", (32, 32, 112)),
                               ("nemotron-4-340b", (96, 8, 192))):
        B, S = 1, 4096
        gen = torch.Generator(device=dev).manual_seed(2)
        q, k, v = (torch.randn(s, generator=gen, device=dev).bfloat16()
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        want = ref_attention(q, k, v, causal=True).float()
        row = []
        for what, lib in libs.items():
            fn = lib.flash_attention_bf16_wgmma
            fn.argtypes = [p] * 4 + [i32] * 6 + [ctypes.c_float, i32, i32, p]
            fn.restype = i32
            out = torch.zeros_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, S, H, KV, hd, hd ** -0.5, 1, dev.index,
                    torch.cuda.current_stream().cuda_stream)
            if fn(*args):
                raise RuntimeError(f"flash {what}: launch failed")
            if what not in FLASH_WRONG or hd not in (96, 112):
                torch.testing.assert_close(out.float(), want, rtol=5e-2,
                                           atol=5e-2)
            row.append(f"{what} "
                       f"{device_ms(lambda: fn(*args), 'flash_bf16'):.4f}")
        del want
        torch.cuda.empty_cache()
        print(f"flash {model} ({B}, {S}, H {H}, KV {KV}, hd {hd}), causal, "
              "device ms: " + "; ".join(row))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablation: needs a CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    ssd_src = _variants("ssd_scan", SSD_VARIANTS)
    simt_src = _variants("ssd_scan", SIMT_SSD_VARIANTS, "_simt")
    hist_src = _variants("fleet_hist", HIST_VARIANTS)
    flash_src = _variants("flash_attention", FLASH_VARIANTS)
    libs = _build_all({**{("ssd", k): v for k, v in ssd_src.items()},
                       **{("simt", k): v for k, v in simt_src.items()},
                       **{("hist", k): v for k, v in hist_src.items()},
                       **{("flash", k): v for k, v in flash_src.items()}})
    ssd({k: v for (kind, k), v in libs.items() if kind == "ssd"})
    ssd_simt({k: v for (kind, k), v in libs.items() if kind == "simt"})
    hist({k: v for (kind, k), v in libs.items() if kind == "hist"})
    flash({k: v for (kind, k), v in libs.items() if kind == "flash"})


if __name__ == "__main__":
    main()
