"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

1. Builds every CUDA kernel of the port from this checkout (one `nvcc` per
   source, all at once) and prints the card, its power limit and the
   toolchain.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (counts bitwise, sums rtol 1e-5).
3. Drives the port's main path at full size through its public entry
   points: `simulate_fleet` on 64 jobs x 1,563 sampled devices (100,032
   device rows) x 24 h of 30 s scrapes -> `StreamingRollup.add_job`
   through the histogram kernel -> `scan_rollup`, which must flag the one
   job with a 2.5x slowdown and no other.  Launch counts are set to 0
   just before and read just after, so the run shows the path went
   through the kernels.
4. Checks the results by the port's own means (shapes, ranges, rollup
   weights and means against the grids, the engine's device half on the
   card against the CPU on the same draws).

Prints the phase times and peak device memory, then one JSON line with
every kernel's record and, last, `{"ok": true, "device": {...}}`.  Exits
non-zero, printing no result, when a phase fails, when CUDA is absent,
or when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM, outside the tensor cores
EDGES = np.linspace(0.0, 1.1, 129)          # StreamingRollup's default bins
N_JOBS, ROWS_PER_JOB, DAY_S, SCRAPE_S, BUCKET_S = 64, 1563, 86400.0, 30.0, 300
SLOW_JOB = "job17"


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg: str):
    if not ok:
        fail(msg)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a repository "
             "checkout")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import fleet_hist as fh

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build and device ------------------------------------------------
    t0 = time.perf_counter()
    _build.build(["fleet_hist"])
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"device: {torch.cuda.get_device_name(dev)}; torch "
          f"{torch.__version__}; torch.version.cuda {torch.version.cuda}; "
          f"nvcc: {nvcc[-1] if nvcc else 'unknown'}")

    # -- 2. kernel vs plain version at the small shapes ----------------------
    rng = np.random.default_rng(0)
    small = {
        "unaligned_513x40": ((513, 40), np.arange(40) // 10, 4),
        "ragged_map_64x25": ((64, 25), np.repeat([0, 1, 2, 3], [3, 9, 9, 4]),
                             4),
    }
    for name, (shape, col, nb) in small.items():
        tpa = rng.uniform(0, 1, shape).astype(np.float32)
        clk = rng.uniform(900, 1558, shape).astype(np.float32)
        grid = (torch.from_numpy(tpa).to(dev), torch.from_numpy(clk).to(dev))
        rec = compare_hist(torch, fh, [grid], col, nb, 1 / 1558.0)
        h, _ = fh.ofu_bucket_hist(*grid, inv_fmax=1 / 1558.0, edges=EDGES,
                                  col_bucket=col, n_buckets=nb)
        check(np.array_equal(h.cpu().numpy(),
                             numpy_hist(tpa, clk, 1 / 1558.0, col, nb)),
              f"{name}: kernel counts differ from the NumPy oracle")
        print(f"fleet_hist {name}: counts bitwise equal, max |dsum| "
              f"{rec['max_abs_err']:.3e}, kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms")

    # -- 3. the main path at full size ---------------------------------------
    from repro_torch.fleet.jobs import JobSpec, simulate_fleet
    from repro_torch.fleet.regression import scan_rollup
    from repro_torch.fleet.streaming import StreamingRollup, weighted_mean
    from repro_torch.telemetry.counters import Event
    specs = [JobSpec(f"job{i:02d}",
                     ("granite-3-2b", "llama3.2-3b")[i % 2], chips=2048,
                     true_duty=0.30 + 0.25 * ((i * 37) % N_JOBS) / (N_JOBS - 1),
                     duration_s=DAY_S, scrape_interval_s=SCRAPE_S, seed=i,
                     straggler_sigma=0.05,
                     events=[Event(DAY_S / 2, DAY_S, slowdown=2.5)]
                     if f"job{i:02d}" == SLOW_JOB else ())
             for i in range(N_JOBS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fh.ofu_bucket_hist.launches = 0
    t0 = time.perf_counter()
    tels = simulate_fleet(specs, max_devices=ROWS_PER_JOB)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    roll = StreamingRollup(bucket_s=BUCKET_S)
    for tel in tels:
        roll.add_job(tel)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    flagged = scan_rollup(roll)
    t3 = time.perf_counter()
    launches = {"fleet_hist": fh.ofu_bucket_hist.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    fleet_ofu = weighted_mean(roll.fleet_stats(qs=()))
    rows = sum(t.grid.n_devices for t in tels)
    print(f"main path: {rows} device rows x {tels[0].grid.tpa.shape[1]} "
          f"samples, {len(tels)} jobs; simulate {t1 - t0:.3f} s, ingest "
          f"{t2 - t1:.3f} s, detect {t3 - t2:.4f} s; fleet-weighted OFU "
          f"{fleet_ofu:.6f}; peak device memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}")

    # -- 4. is it right ------------------------------------------------------
    check(launches["fleet_hist"] >= N_JOBS,
          f"ingest launched the histogram kernel {launches['fleet_hist']} "
          f"times for {N_JOBS} jobs")
    check(set(flagged) == {SLOW_JOB},
          f"detector flagged {sorted(flagged)}, expected only {SLOW_JOB}")
    reg = flagged[SLOW_JOB][0]
    print(f"detector: {SLOW_JOB} flagged at bucket {reg.start_idx}, factor "
          f"{reg.factor:.3f}")
    check(reg.factor > 1.5 and abs(reg.start_idx - 144) <= 6,
          f"regression of {SLOW_JOB} misplaced: {reg}")
    check_grids(torch, tels, specs)
    check_rollup(roll, tels)
    check_device_half(torch, dev)

    # the kernel against its plain version at the main path's shape: every
    # grid the main path handed it
    grids = [(t.grid.tpa, t.grid.clock_mhz) for t in tels]
    b_abs = np.maximum(np.ceil(tels[0].grid.times_s / BUCKET_S)
                       .astype(int) - 1, 0)
    inv_fmax = 1.0 / specs[0].chip.f_max_mhz
    rec = compare_hist(torch, fh, grids, b_abs - b_abs[0],
                       int(b_abs[-1] - b_abs[0]) + 1, inv_fmax)
    print(f"fleet_hist main path {ROWS_PER_JOB}x{grids[0][0].shape[1]} "
          f"(x{len(grids)} grids): counts bitwise equal, max |dsum| "
          f"{rec['max_abs_err']:.3e}, kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    whole = compare_hist(torch, fh, [(torch.cat([g[0] for g in grids]),
                                      torch.cat([g[1] for g in grids]))],
                         b_abs - b_abs[0], int(b_abs[-1] - b_abs[0]) + 1,
                         inv_fmax, reps=5)
    print(f"fleet_hist whole fleet in one call {rows}x"
          f"{grids[0][0].shape[1]}: kernel {whole['ms']:.4f} ms, plain "
          f"{whole['plain_ms']:.4f} ms, bound {whole['bound_ms']:.4f} ms")
    profile_phases(torch, specs, {"simulate": t1 - t0, "ingest": t2 - t1})

    kernels = [{"name": "fleet_hist", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fleet_hist.cu",
                "replaces": "src/repro/kernels/fleet_hist.py:79",
                "launches": launches["fleet_hist"], **rec,
                "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def numpy_hist(tpa, clk, inv_fmax, col, nb):
    """NumPy oracle of the histogram counts (f32 OFU, searchsorted)."""
    ofu = tpa * clk * np.float32(inv_fmax)
    e32 = EDGES.astype(np.float32)
    k = np.clip(np.searchsorted(e32, ofu.ravel(), side="right") - 1, 0,
                len(e32) - 2)
    seg = np.broadcast_to(np.asarray(col)[None, :], ofu.shape).ravel()
    hist = np.zeros((nb, len(e32) - 1), np.int64)
    np.add.at(hist, (seg, k), 1)
    return hist


def compare_hist(torch, fh, grids, col, nb, inv_fmax, reps=1) -> dict:
    """The kernel against its plain version on each grid (counts bitwise,
    sums rtol 1e-5), then both timed over the same grids with CUDA events:
    the kernel launch by launch into pre-zeroed outputs, the plain version
    call by call.  Returns the record's measured and bound fields."""
    dev = grids[0][0].device
    err = 0.0
    for tpa, clk in grids:
        h, s = fh.ofu_bucket_hist(tpa, clk, inv_fmax=inv_fmax, edges=EDGES,
                                  col_bucket=col, n_buckets=nb)
        hp, sp = fh.bucket_hist_torch(tpa, clk, inv_fmax=inv_fmax,
                                      edges=EDGES, col_bucket=col,
                                      n_buckets=nb)
        torch.cuda.synchronize()
        check(torch.equal(h.long(), hp), "kernel counts differ from the "
              f"plain version at {tuple(tpa.shape)}")
        close = torch.isclose(s, sp, rtol=1e-5, atol=0.0)
        check(bool(close.all()), "kernel sums differ from the plain "
              f"version at {tuple(tpa.shape)} beyond rtol 1e-5")
        err = max(err, float((h.long() - hp).abs().max()),
                  float((s - sp).abs().max()))

    edges = torch.from_numpy(EDGES.astype(np.float32)).to(dev)
    col_t = torch.from_numpy(np.asarray(col, np.int32)).to(dev)
    bins = len(EDGES) - 1
    launch = fh._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    hist = torch.zeros((len(grids), nb, bins), dtype=torch.int32, device=dev)
    sums = torch.zeros((len(grids), nb), dtype=torch.float64, device=dev)

    def kernel_pass():
        for i, (tpa, clk) in enumerate(grids):
            D, S = tpa.shape
            rc = launch(tpa.data_ptr(), clk.data_ptr(), D, S,
                        fh.rows_per_block(D, S), col_t.data_ptr(),
                        edges.data_ptr(), bins, float(np.float32(inv_fmax)),
                        hist[i].data_ptr(), sums[i].data_ptr(), dev.index,
                        stream)
            check(rc == 0, f"fleet_hist launch failed: CUDA error {rc}")

    def plain_pass():
        for tpa, clk in grids:
            fh.bucket_hist_torch(tpa, clk, inv_fmax=inv_fmax, edges=EDGES,
                                 col_bucket=col, n_buckets=nb)

    ms = event_ms(torch, kernel_pass, reps) / len(grids)
    plain_ms = event_ms(torch, plain_pass, reps) / len(grids)
    D, S = grids[0][0].shape
    n_bytes = D * S * 8 + S * 4 + (bins + 1) * 4 + nb * bins * 4 + nb * 8
    n_ops = D * S * 3                       # two products and one sum
    bound = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": n_ops / FP32_FLOP_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[bound_by], "bound_by": bound_by}


def profile_phases(torch, specs, walls: dict) -> None:
    """Device busy time of the simulate and ingest phases, from
    torch.profiler over a second, identical run of each (the timed run
    above carries no profiler cost), set against that run's wall time:
    the device's idle share, its kernel launches and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet.jobs import simulate_fleet
    from repro_torch.fleet.streaming import StreamingRollup
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as sim_prof:
        tels = simulate_fleet(specs, max_devices=ROWS_PER_JOB)
        torch.cuda.synchronize()
    roll = StreamingRollup(bucket_s=BUCKET_S)
    with profile(activities=acts) as ing_prof:
        for tel in tels:
            roll.add_job(tel)
        torch.cuda.synchronize()
    for phase, prof in (("simulate", sim_prof), ("ingest", ing_prof)):
        dev = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
               for e in prof.key_averages()]
        dev = sorted((d for d in dev if d[0] > 0), reverse=True)
        busy_s = sum(d[0] for d in dev) / 1e6
        if not dev:
            print(f"profile {phase}: device time not measured (the profiler "
                  "saw no device activity)")
            continue
        top = "; ".join(f"{k[:48]} {us / 1e3:.2f} ms x{n}"
                        for us, n, k in dev[:4])
        print(f"profile {phase}: device busy {busy_s:.4f} s of "
              f"{walls[phase]:.4f} s wall (idle share "
              f"{1 - busy_s / walls[phase]:.3f}), "
              f"{sum(d[1] for d in dev)} device ops; top: {top}")


def event_ms(torch, fn, reps: int) -> float:
    """Device time of one call of fn, over reps calls after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_grids(torch, tels, specs) -> None:
    """Every grid: the expected shape on the card, finite, duty in [0, 1],
    clock in the clock model's [f_min, f_max]."""
    f_max = specs[0].chip.f_max_mhz
    for tel in tels:
        tpa, clk = tel.grid.tpa, tel.grid.clock_mhz
        check(tpa.is_cuda and tuple(tpa.shape) == (ROWS_PER_JOB,
                                                    int(DAY_S / SCRAPE_S)),
              f"{tel.spec.job_id}: grid {tuple(tpa.shape)} on {tpa.device}")
        check(bool(torch.isfinite(tpa).all() & torch.isfinite(clk).all()),
              f"{tel.spec.job_id}: non-finite counters")
        check(0.0 <= float(tpa.min()) and float(tpa.max()) <= 1.0,
              f"{tel.spec.job_id}: duty outside [0, 1]")
        check(0.6 * f_max - 1e-3 <= float(clk.min())
              and float(clk.max()) <= f_max + 1e-3,
              f"{tel.spec.job_id}: clock outside [f_min, f_max]")


def check_rollup(roll, tels) -> None:
    """Rollup state against the grids it came from: every bucket holds
    each job's samples at its chip weight, and each job's rollup mean
    OFU equals its mean over the grid on the card."""
    from repro_torch.fleet.streaming import weighted_mean
    spb = int(BUCKET_S / SCRAPE_S)
    for tel in tels:
        st = roll.job_stats(tel.spec.job_id, qs=())
        want = spb * ROWS_PER_JOB * tel.spec.chips / ROWS_PER_JOB
        check(len(st.weight) == int(DAY_S / BUCKET_S)
              and np.allclose(st.weight, want, rtol=1e-12),
              f"{tel.spec.job_id}: bucket weights {st.weight[:3]}..., "
              f"expected {want}")
        check(abs(weighted_mean(st) - tel.ofu) <= 1e-5 * tel.ofu,
              f"{tel.spec.job_id}: rollup OFU {weighted_mean(st)} vs grid "
              f"OFU {tel.ofu}")


def check_device_half(torch, dev) -> None:
    """The engine's device half on the card against the same function on
    the CPU, fed the same normal draws, on a small evented group: tpa to
    rtol 1e-6, clock to 1e-2 MHz (the tolerances the CPU tests hold the
    CPU half to against the JAX reference)."""
    from repro_torch.fleet.engine import EngineParams, JobSlot, group_slots
    from repro_torch.fleet.engine_torch import _group_device_sim, _group_inputs
    from repro_torch.telemetry.counters import Event, StepProfile
    slots = [JobSlot(StepProfile(0.8, 2.0), 1500.0, 30.0,
                     stragglers=np.array([1.0, 1.2, 0.9])),
             JobSlot(StepProfile(0.5, 1.0), 1200.0, 30.0,
                     events=[Event(300.0, 900.0, slowdown=2.5)],
                     stragglers=np.array([1.0, 1.6, 1.1]))]
    (members,) = group_slots(slots).values()
    inp = _group_inputs(members, EngineParams())
    D, S = len(inp.strag), inp.base_end.shape[1]
    rng = np.random.default_rng(0)
    z = rng.standard_normal((D, S)).astype(np.float32)
    dw = rng.standard_normal((S, D)).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = _group_device_sim(
            *inp.tensors(d), torch.from_numpy(z.copy()).to(d),
            torch.from_numpy(dw.copy()).to(d), n_sub=inp.n_sub,
            consts=inp.consts)
    (tc, cc), (tg, cg) = out["cpu"], out[str(dev)]
    tpa_err = float(((tg.cpu() - tc).abs() / tc.abs().clamp_min(1e-30)).max())
    clk_err = float((cg.cpu() - cc).abs().max())
    print(f"engine device half, card vs CPU on the same draws ({D}x{S}): "
          f"tpa max rel {tpa_err:.2e}, clock max abs {clk_err:.2e} MHz")
    check(tpa_err <= 1e-6 and clk_err <= 1e-2,
          "engine device half on the card disagrees with the CPU")


if __name__ == "__main__":
    main()
