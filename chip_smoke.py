"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

1. Builds every CUDA kernel of the port from this checkout (one `nvcc` per
   source, all at once) and prints the card, its power limit and the
   toolchain.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (counts bitwise, sums rtol 1e-5), and
   the histogram kernel at an S that is not a multiple of 4 and on OFU
   outside the edges and NaN.
3. Drives the port's main path at full size through its public entry
   points: `simulate_fleet` on 64 jobs x 1,563 sampled devices (100,032
   device rows) x 24 h of 30 s scrapes -> `StreamingRollup.add_job`
   through the histogram kernel -> `scan_rollup`, which must flag the one
   job with a 2.5x slowdown and no other.  The kernel is then timed on
   each job's grid, on the whole fleet in one call and, with geometric
   edges that its uniform-grid guess misses, on one grid.  Launch counts
   are set to 0 just before and read just after, so the run shows the
   path went through the kernels.
4. Checks the results by the port's own means (shapes, ranges, rollup
   weights and means against the grids, the engine's device half on the
   card against the CPU on the same draws).
5. Drives the serve path, the paper's deployment, at the same size: one
   `SimulatorSource` a job simulating on the card (64 jobs x 1,563
   devices x 30 s scrapes over the day) -> `Collector` (24 rounds of
   1 h into a day-long `WindowedRollup`, the histogram kernel ingesting
   every job's grid every round) -> `ServiceDaemon` paced by a
   `SimClock` -> `FleetAPIServer` on 127.0.0.1, read by `FleetClient`.
   The kernel's launch count is set to 0 just before the daemon runs and
   read just after (at least 64 x 24).  Fails unless the regression
   alerts are exactly the slowed job's, its episode starts within 6
   buckets of bucket 144, the rollup's counts equal the plain version's
   bitwise on every polled grid (sums rtol 1e-5), a second collector
   fed the same grids from the host through `GridSource`s fires the same
   alerts by (round, job, kind), and the API answers /v1/fleet, a job,
   /v1/alerts (equal to the collector's) and top regressions (the slowed
   job first) with 200 and a repeated /v1/fleet with 304.  Prints the
   rounds, samples, wall time split into poll and ingest (and the
   ingest alone, `WindowedRollup.add_grid`), detect and publish, the
   median GET latency and peak device memory beside the card's name and
   power limit.
6. Runs the labelled-incident scorecard on the card: `run_scorecard` over
   the 8 scenarios at their own geometry (2 h of 30 s scrapes, 300 s
   rounds, 4 sampled devices a job), the histogram kernel ingesting every
   replayed grid.  Fails unless every pinned floor holds, the kernel
   launched once a (job, round) grid with samples (816, worked out from
   the scenarios) and a replay of the same grids from the host fires the
   same alerts.  Prints each (scenario, detector)'s precision, recall and
   time-to-detect beside the reference's in
   `tests/data/golden_scorecard.json`, for reading only.
7. Runs the paper's Table III / Fig. 5 fleet at every GPU on the card:
   `table3.build_jobs(max_devices=5888)`, 608 jobs, 389,744 devices x 40
   samples, batch-ingested (608 launches, counts bitwise and sums rtol
   1e-5 against the plain version on every job grid) and analysed by
   `divergence.analyze` and `analyze_correlation`, then replayed live
   through a `Collector` (4 rounds, 2,432 launches), `FleetStore` and
   the HTTP API.  Fails unless exactly the 82 `naive_moe` and
   `naive_hybrid` jobs are flagged on both detectors and in the live
   miscalc alerts, r after exclusion >= 0.75 and the live per-job
   bucket counts equal the offline ones (means within rtol 1e-5: the
   kernel's sums land by atomics in no fixed order).  Prints r, MAE, the
   per-scale rows and the wall time of simulate, ingest, analyze and the
   live replay, and profiles two live rounds.
8. Runs the DCGM acquisition tier over 8 GPUs whose counters are
   simulated on the card (`FakeDcgmTransport`, 1 h of 30 s scrapes, a
   2.5x slowdown from 1,800 s) -> `make_dcgm_backends` ->
   `BackendSource` -> `Collector` -> `ServiceDaemon` -> `FleetAPIServer`.
   Fails unless every backend is healthy after 960 polls, the
   regression alert is served, the served series equal bitwise those of
   the simulator's chunks copied to host and replayed the same way,
   injected transport faults change no sample, and the simulator's card
   grids ingested by the kernel (12 launches) give the same alerts,
   series within rtol 1e-5 and counts apart by at most the samples
   within 4 f32 ulps of a bin edge.  Prints whether `dcgmi` is on PATH
   and `pynvml` imports; no transport is chosen from it.
9. Holds the kernel API's kernels (GEMM, SSD intra-chunk, flash
   attention) against their plain versions at the JAX tests' shapes and
   tolerances, ragged flash shapes included, and the TMA + wgmma paths
   at shapes of their own: bf16 GEMMs whose K_eff (64, 128, 3,072) runs
   the stage ring short of its depth and round it many times, int8 GEMMs
   at K_eff 128, 512, 640, 3,072 and 6,144 (bitwise), 60 bf16 flash
   shapes at hd 64, 96, 112, 128 and 192, GQA groups of 1, 3 and 4,
   causal and full, Sk = 200 and Sq = 100, and bf16 SSD at Q 64-320, hd
   64/128, ds 64-256, g 1, 2 and nh and more work items than SMs, each
   seen to launch its wgmma variant; f32 GEMMs at unpadded shapes,
   straight into the SIMT kernel's zero-filled edges, and f32 flash at
   hd 192 and 256 on the SIMT kernel.
10. Drives the kernel API's paths at full model width, each with the
   launch counts set to 0 just before and read just after: the GEMM
   characterization table and `ops.matmul` on the two dominant GEMMs of
   granite-3-2b and llama3.2-3b in bf16, fp32 and int8, and on
   whisper-small's two encoder GEMMs (1,500 tokens, not tile-aligned) in
   bf16.  The Eq. 3 padding is checked exactly: the FLOPs of the padded
   grid each call hands the kernel == GemmProfile.profiled_flops == the
   closed form, and the bf16 executed/theoretical ratio == the tile
   factor (the fleet engine's, 1, for the aligned models; 1.024 for
   whisper's).
   `ops.ssd` at mamba2-780m and at zamba2-7b width (S = 4,096, 48 heads
   of one group, 112 heads of two), in bf16 (the tensor-core kernel) and
   in f32 (the SIMT kernel); `ops.flash` (S = 4,096, causal) in bf16 at
   llama3.2-3b (hd 128, GQA), phi-3-vision-4.2b (hd 96), zamba2-7b (hd
   112) and nemotron-4-340b (hd 192, GQA) width, and in f32 at
   phi-3-vision-4.2b and zamba2-7b width (the SIMT kernel).  Each is held
   against its plain version (at full width to 2^-6 of the value plus
   2^-5 of the row's RMS, a limit shown to reject a zeroed output, one
   with the kernel's own diagonal tile dropped, for flash past hd 64 one
   that drops the second 64-column box and, for SSD, one with the decays
   of the next head of the kernel's head block; f32 flash also to the
   JAX tests' 1e-3) and timed beside its bound and a library call (for
   SDPA, the CUDA kernel it ran, named by `torch.profiler`).  The
   per-variant launch counts must show every bf16 GEMM, the four bf16
   flash calls and both bf16 SSD calls on the bf16 wgmma kernels, the
   two f32 flash calls and both f32 SSD calls on the SIMT ones, every
   int8 GEMM on the s8 one and the fp32 GEMMs on the SIMT one; the
   redesigned kernels print their TFLOP/s, share of bound, factor to the
   library call or the former kernel's time (the f32 SIMT calls the
   former SIMT kernels' times), the int8 GEMMs their transpose's time
   alone, and the FFN GEMM's int8 and fp32 paths the SM clock and power
   draw under load, kernel and library call.
   10b. B3's backward (`csrc/flash_bwd.cu`, which `kernels.grad`'s
   `flash_bwd` routes bf16 at hd 64 and 128 to) at granite-3-2b's train
   layer (B 8, S 4,096, 32 heads over 8 kv heads of 64, causal) and at
   llama3.2-3b's (B 1, 24 over 8 heads of 128): dq, dk and dv against
   `flash_bwd_plain` in f32 on the same bf16 inputs, each element within
   2^-6 of it + 2^-5 of its summands' root-sum-square (P and dS are
   rounded to bf16 before their products, and a gradient's summands
   cancel) and the whole within 1e-2 of its RMS, a check which must
   reject a zeroed gradient, the dq that `grad_mutants`' dq-zeroed gives
   through autograd, a dq 2^-3 too large and a dk with one 64-key tile
   dropped; two calls bitwise equal; one call on the kernel route and
   three kernel launches a call; the kernels' time beside their bound
   (2.5x the forward's: five products a causal pair), the plain
   version's and SDPA's backward (the library's, timed only).
   10c. B4's backward (`csrc/ssd_bwd.cu`, which `kernels.grad`'s
   `ssd_intra_bwd` routes bf16 at hd 64 to) at zamba2-7b-instruct's
   Mamba2 layer in its train cell (BC 32 chunks of Q 256, 112 heads of
   64, 2 groups, state 64): dx, d dt, d dacs, db and dc against
   `ssd_intra_bwd_plain` in f32 on the same bf16 inputs, dx, db and dc
   by the check of 10b and d dt and d dacs, f32 sums rounded nowhere, by
   one 2^7 times tighter (2^-12 of an element's summands'
   root-sum-square, a relative RMS of 1e-5), each element's summands
   from `ref.ssd_bwd_scales`; the checks must reject a zeroed gradient,
   what the router gives under `grad_mutants`' d-dacs-dropped and
   next-head-decays, a dB with one 64-column tile's contribution
   dropped, and d dt and d dacs summed from dM rounded to bf16 (the
   plain version so patched); two calls bitwise equal; one
   call on the kernel route and three kernel launches a call; the
   kernels' time (each kernel's from the profiler, where it sees them)
   beside their bound, the plain version's and B4's forward.

11. Serves zamba2-7b at full width (bf16, 6.79 B parameters from a
   seeded generator on the card) through the port's entry points:
   `make_prefill_step` on `make_inputs` at S = 4,096, which must launch
   exactly 14 flash and 81 SSD kernels, all on their tensor-core
   variants (timed; MFU from `step_flops`; a profiler over one
   forward), then the `launch.serve` greedy loop at B = 4, ctx = 4,096,
   32 tokens (ms a token beside the byte bound; host launches a token).
   Correctness at full width: one layer group (the shared block and
   layers 0-5, S = 512) on the card against the CPU's plain route in f32
   (`close_rows`) and bf16 (`bf16_close`), and 64 tokens decoded one by
   one against one forward over them at full depth, in bf16 and, as the
   witness that the bf16 gap is rounding, in f32, each limit shown to
   reject an attention output set to zero, an SSD without its diagonal
   term and an SSD with the next head's decays; then llama3.2-3b,
   mamba2-780m and whisper-small at published width and 2 layers,
   forward and 4 decode steps against the CPU with exact launch counts.
12. Trains zamba2-7b at full width on phase 11's parameters through the
   port's `Trainer` (S = 4,096, B = 1, AdamW with a bf16 first moment
   and a factored second moment): one warm-up step, 3 timed, one under
   the profiler, each of which must launch exactly 28 flash and 162 SSD
   kernels on their tensor-core variants (14 and 81 in the forward, the
   same again in remat's recompute; the autograd Functions' backwards
   launch none of these), call the attention backward 14 times, each
   on the plain route (hd 112), and call the SSD backward 81 times, each
   on the kernel route (`grad.ssd_bwd_routes()`), its three kernels 81
   times each.  Prints step s, tokens/s, MFU from `train_step_flops`
   without and with the recompute, the loss of each step, peak memory,
   the idle share and the top ops.  Correctness: (a) one layer group's
   gradients (the shared block and layers 0-5, S = 512) for every leaf in
   f32 through the kernels against autograd through the plain versions
   on the card, each leaf within `close_rows`' limit, which must reject
   a flash backward with dq = 0, an SSD backward without its d dacs term
   and one with the next head's decays, and the same in bf16, no further
   from the f32 gradients than 1.25x the CPU's plain bf16 route; (b)
   after the full-width steps every gradient (by layer) finite and
   non-zero, every matrix and f32 leaf moved, every loss finite; (c)
   llama3.2-3b, mamba2-780m and whisper-small at published width and 2
   layers, in f32: a train step on the card against the CPU with exact
   launch counts, then a crash after a checkpoint, a restore and a
   resume whose last loss equals an uninterrupted run's; (d) one
   granite-3-2b train step at full width (bf16, B 1, S 512), the main
   path of its benchmark cell, which must call the attention backward 40
   times, each on the kernel route (120 launches), with a finite loss.
13. Runs the paper's benchmark suite on the card at the reference's own
   sizes (`repro_torch.benchmarks.run`'s modules: Fig. 1, Fig. 3,
   Table I, Table II, Fig. 5 / Table III / §V-C over the 608-job fleet,
   §VI, and the fleet engine at 1,000 devices x 1 h, the 600-job sweep,
   100,000 devices x 1 h and the 10k-host ingest tier, and the roofline,
   which finds no dry-run records there yet; its CSV goes to
   build/bench/), with the histogram and GEMM kernels' counts set to 0
   just before and read just after.  Fails unless every module runs,
   every Fig. 1 closed-form, Fig. 3, Table I and Table II row equals the
   port's own CPU run of it, Fig. 1's kernel rows are exact, Fig. 5
   flags exactly the 82 affected jobs with r after exclusion >= 0.75,
   the fleet engine's kernel ingest counts equal its plain version's,
   and the histogram kernel launched at least 608 times and the GEMM at
   least 3.  Then drives Fig. 1's sweep through the GEMM kernel at the
   sweep's sizes (N 4,096, 8,192 and 16,384, and the sweep's first
   three random shapes with every side >= 4,096) in bf16, int8 and
   fp32: launched FLOPs == GemmProfile == closed form on every call, 64
   rows of each output against a float64 product, the kernel's ms and
   TFLOP/s, launches by variant.  Last, the examples on the card:
   quickstart trains zamba2-7b's smoke config 10 steps (exact flash and
   SSD launch counts, finite losses) and a re-run resumes from its
   checkpoint; fleet_monitoring flags the jobs it flags on the CPU;
   mixed_precision_pretrain's OFU tracks its MFU shift.
14. (a) Holds zamba2-7b's flash and SSD calls through the ops
   `repro_torch::flash_attention` and `repro_torch::ssd_intra` (the
   launch as a `torch.library.custom_op`, which the dry run traces)
   bitwise equal to the kernels' direct launch on the same inputs, and
   prints each op's host time a call beside the direct launch's and the
   kernel's; phases 11 and 12 have already held the ops' launch counts
   (14 and 81 a prefill, 28 and 162 a train step).  (b) Dry-runs
   (`launch.dryrun.run_cell`, fake CUDA tensors, nothing launched or
   counted) the three steps phases 11 and 12 ran: its FLOPs beside
   `step_flops`, its peak beside the card's measured peak; fails unless
   the prefill's and the train step's lie within 15 % of the measured
   peaks, a limit that must reject a tracker that never frees and one
   that counts only the arguments.  (c) Prints the roofline of those
   records against the H100 SXM data sheet (989 TFLOP/s bf16, 3.35 TB/s)
   beside the measured times, and `benchmarks.report`'s two tables.  (d)
   Runs the six CLIs' `--self-check` (`repro_torch.tools.*`) on the card
   in this process, each of which must return 0, with the histogram
   kernel's launches counted per CLI (their output goes to build/tools/).
   (b') The dry run on the production mesh: zamba2-7b and nemotron-4-340b
   at train_4k, prefill_32k and decode_32k on 16 x 16, each cell traced
   as one of 256 H100s sees it (DTensors over a fake process group of
   512 ranks, meta tensors), one process a cell, started beside phase 1
   and read here (`--mesh-cell`; records in build/dryrun_mesh/).  Prints
   per device the argument bytes, which must equal the sum of the local
   shards' bytes computed from the specs alone, the peak and temporary
   bytes and whether the peak fits 80 GB, the collectives' wire bytes
   and counts by kind, which must not all be 0, and the roofline's
   compute, memory and collective terms; fails unless B3 and B4 launched
   nothing in any of those processes or this one, and unless each cell's
   peak, wire bytes and FLOPs agree within 1 % with the CPU's trace of
   the same cell (`MESH_CPU`: DTensor's placements may change with
   PyTorch's version, and the card's differs).  (e) A real one-rank
   `nccl` process group (a `FileStore` in build/) and a (1, 1) mesh:
   zamba2-7b at full width, 6 layers, prefill at S 4,096, its parameters
   as DTensors; the logits must be bitwise equal to the unsharded port's
   on the same parameters, with B3 and B4 launched as many times, through
   their sharding rules; the group is destroyed afterwards.
15. The paper's own measurement on the card.  (a) Fig. 1's sweep through
   the GEMM kernel again under the H100's tile policies
   (`pick_policy(..., chip=H100_SXM)`: the kernel's own tiles), launched
   FLOPs == GemmProfile == closed form on every call.  (b) A host thread
   polls the card every 0.2 s through the port's acquisition tier
   (`PynvmlTransport` -> `DcgmFieldBackend`, strict) over windows
   bracketed by `torch.cuda.synchronize()`: idle, the GEMM kernel in
   bf16, int8 and fp32 at N 8,192 and in bf16 at Fig. 1's first ragged
   shape, each repeated for 3 s under the H100's policies, and phase
   12's three timed zamba2-7b train steps (the poller starts in phase
   12).  Each window prints its tensor-activity source (NVML's field,
   its GPM metric, or `utilization.gpu`, which is not tensor activity),
   mean reading, mean and least SM clock, OFU = mean(TPA·f) / 1,830 MHz,
   MFU over the type's `H100_SXM` peak (theoretical FLOPs over the
   window; `train_step_flops` with and without remat's recompute for
   the train steps) and the tile-corrected OFU's gap from MFU in points.
   Fails unless NVML connects, every reading passes the backend's range
   checks, the SM clock is non-zero in every window and, with a true
   tensor source, bf16 lifts TPA >= 0.2 above idle while true f32 stays
   below 0.1.  (c) Serves `python -m repro_torch.tools.fleet_live
   --transport pynvml --chip h100-sxm` (3 rounds of 3 s) in this process
   on a free local port: a `FleetClient` must read its fleet series over
   HTTP, and it must return 0 with its backend healthy (its output goes
   to build/counters/).

Prints the phase times and peak device memory, then one JSON line with
every kernel's record (the histogram kernel's also carries
`serve_launches`, `scorecard_launches`, `table3_launches` and
`live_launches`, its counts over phases 5-8; the flash and SSD kernels'
carry their other widths and working types under `paths` (" f32" for
the SIMT kernels' f32 calls), `model_launches`, their launches in phase 11's prefill, and
`train_launches`, their launches a phase 12 train step (the SSD
kernel's `backward`, phase 10c's record, carries the backward's); the
histogram
and GEMM kernels' carry `bench_launches`, their counts over phase 13's
benchmark suite; the histogram kernel's carries `tools_launches`, its
launches in each of phase 14's CLI self-checks; the histogram and GEMM
kernels' carry `counters_launches`, their counts over phase 15, and the
flash and SSD kernels' and the SSD backward's theirs over phase 15's
train window) and, last,
`{"ok": true, "device": {...}}`.  Exits non-zero, printing no result,
when a phase fails, when CUDA is absent, or when run outside a checkout
of the repository.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

#: H100 SXM data-sheet rates (`repro_torch.benchmarks.roofline`, set by
#: `main` once the checkout's package is on the path): HBM bytes/s, f32
#: outside the tensor cores, and peaks by input type
HBM_BYTES_PER_S = FP32_FLOP_PER_S = PEAK_OPS_PER_S = None
EDGES = np.linspace(0.0, 1.1, 129)          # StreamingRollup's default bins
#: far from uniform, so the kernel's guess misses and its search decides
GEOMETRIC_EDGES = np.geomspace(1e-3, 1.1, 129)
#: the former histogram kernel's times, printed beside the new one's
#: (NVIDIA H100 80GB HBM3, 700.00 W, this script's run of it; PERF.md):
#: per job grid over the main path's 64, and the whole fleet in one call
OLD_HIST_MS = {"grid": 0.0395, "fleet": 1.95}
N_JOBS, ROWS_PER_JOB, DAY_S, SCRAPE_S, BUCKET_S = 64, 1563, 86400.0, 30.0, 300
#: the serve path's collector rounds, over the main path's whole day,
#: and the detector settings of the batch path's `scan_rollup` (its
#: defaults)
ROUND_S = 3600.0
DETECTOR = {"window": 10, "factor_threshold": 1.5, "min_duration": 5}
SLOW_JOB = "job17"
#: Table III at every GPU: the largest job's chips as the per-job cap
TABLE3_DEVICES = 5888
REPS = 3                        # timed launches after one warm-up
#: for a kernel of ~0.05 ms, whose first timed launch's ~0.04 ms of host
#: work (the events bracket it) would add a quarter over 3 launches
SHORT_REPS = 20
# the JAX package's kernel tests' shapes (tests/test_kernels.py)
GEMM_SHAPES = [(128, 128, 128), (256, 512, 384), (300, 150, 200),
               (1, 128, 128), (129, 257, 513)]
FLASH_SHAPES = [(2, 128, 128, 8, 8, 32, True), (2, 128, 128, 8, 2, 32, True),
                (1, 64, 128, 4, 4, 16, False), (2, 256, 256, 4, 1, 64, True)]
SSD_SHAPES = [(4, 16, 4, 16, 8, 2), (2, 32, 8, 8, 16, 4), (1, 64, 2, 32, 4, 2)]
GEMM_MODELS = ("granite-3-2b", "llama3.2-3b")   # the simulated fleet's
RECORD_GEMM = ("llama3.2-3b", (4096, 8192, 3072), "bf16")
#: times of the kernels the TMA + wgmma paths replaced, printed beside the
#: new ones (NVIDIA H100 80GB HBM3, 700.00 W, this script's run of the
#: former kernels; PERF.md): the bf16 GEMMs on the wmma kernel by (model,
#: shape)
WMMA_GEMM_BF16_MS = {
    ("granite-3-2b", (4096, 2048, 2048)): 0.6461,
    ("granite-3-2b", (4096, 8192, 2048)): 2.4846,
    ("llama3.2-3b", (4096, 3072, 3072)): 1.3871,
    ("llama3.2-3b", (4096, 8192, 3072)): 3.7678,
    ("whisper-small", (1500, 768, 768)): 0.0983,
    ("whisper-small", (1500, 3072, 768)): 0.2044}
#: the former SIMT kernels' times by (model, working type), printed beside
#: the kernel that now takes the call (the same card; PERF.md names each
#: run): flash and SSD in bf16, since run by the tensor-core kernels, and
#: in f32, which the register-tiled SIMT kernels now run (this script's
#: `ssd_path` and `flash_path` on the package of commit cac39fd)
SIMT_FLASH_MS = {("llama3.2-3b", "bf16"): 15.5825,
                 ("phi-3-vision-4.2b", "bf16"): 19.8532,
                 ("phi-3-vision-4.2b", "f32"): 19.4966,
                 ("zamba2-7b", "f32"): 20.3246}
SIMT_SSD_MS = {("mamba2-780m", "bf16"): 2.2543,
               ("mamba2-780m", "f32"): 2.1796, ("zamba2-7b", "f32"): 2.7833}
#: times of the former untuned SIMT kernel on the fp32 and int8 model
#: GEMMs (NVIDIA H100 80GB HBM3, 700.00 W, this script's run of it;
#: PERF.md), printed beside the redesigned kernels'
OLD_SIMT_GEMM_MS = {
    ("granite-3-2b", (4096, 2048, 2048), "fp32"): 1.4812,
    ("granite-3-2b", (4096, 8192, 2048), "fp32"): 5.7762,
    ("llama3.2-3b", (4096, 3072, 3072), "fp32"): 3.3690,
    ("llama3.2-3b", (4096, 8192, 3072), "fp32"): 8.7385,
    ("granite-3-2b", (4096, 2048, 2048), "int8"): 1.7227,
    ("granite-3-2b", (4096, 8192, 2048), "int8"): 6.4759,
    ("llama3.2-3b", (4096, 3072, 3072), "int8"): 3.6918,
    ("llama3.2-3b", (4096, 8192, 3072), "int8"): 9.7680}
#: bf16 flash shapes of the tensor-core kernel: every hd it takes (96 and
#: 112 zero-filled past hd in their second box, 192 in three boxes with
#: 64-key tiles), G = H / KV of 1, 3 and 4, causal and full, ragged Sk
#: (200) and Sq (100)
TC_FLASH_SHAPES = [(2, Sq, Sk, 2 * G, 2, hd, causal)
                   for hd in (64, 96, 112, 128, 192) for G in (1, 3, 4)
                   for causal in (True, False)
                   for Sq, Sk in ((128, 200), (100, 100))]
#: f32 flash shapes of the SIMT kernel's 8-dims-a-lane class (hd > 128)
SIMT_WIDE_FLASH_SHAPES = [(1, 200, 230, 8, 2, 192, True),
                          (1, 130, 200, 4, 2, 256, False)]
#: bf16 SSD shapes of the tensor-core kernel, (BC, Q, nh, hd, g, ds): Q of
#: a half, one and a half and two and a half strips, hd 64 and 128, ds 64
#: to 256 (256: one stage), g 1, 2 and nh, 2 heads an item and 1 (3 heads
#: a group), and more items than SMs (each block runs several)
TC_SSD_SHAPES = [(1, 64, 2, 64, 1, 64), (50, 192, 6, 64, 2, 192),
                 (2, 256, 8, 64, 1, 128), (2, 256, 6, 64, 6, 64),
                 (1, 320, 2, 128, 2, 256), (70, 128, 4, 64, 1, 256)]
#: bf16 GEMMs whose K_eff (64, 128, 3,072) runs the 4-stage ring shorter
#: than its depth, twice, and 48 times round; N_eff 256, 384 and 512 take
#: N tiles of 256, 128 and 256
TC_GEMM_SHAPES = [((128, 256, 64), (128, 128, 64)),
                  ((200, 384, 100), (128, 128, 128)),
                  ((256, 512, 3072), (128, 128, 128))]
#: int8 GEMMs whose K_eff (128, 512, 640, 3,072, 6,144) runs the ring of
#: 128-deep stages short, exactly full, once round and many times round;
#: N_eff 256 and 384 take N tiles of 256 and 128
S8_GEMM_SHAPES = [(100, 256, 128), (200, 384, 500), (256, 256, 640),
                  (300, 250, 3072), (128, 384, 6144)]
#: f32 GEMMs straight into the kernel, unpadded: zero fill past M, N and
#: K, and 4-byte copies where K or N is not a multiple of 4
F32_RAGGED_SHAPES = [(129, 257, 513), (300, 150, 200), (1, 3, 5),
                     (200, 136, 100)]
#: bf16 at full width: 2-4 ulps of the value, plus 4-8 ulps of its row's
#: RMS for the elements that cancel to near 0
BF16_RTOL, BF16_ROW_ATOL = 2 ** -6, 2 ** -5


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg: str):
    if not ok:
        fail(msg)


def card_name() -> str:
    """The card's name and power limit, from `nvidia-smi`."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a repository "
             "checkout")
    sys.path.insert(0, str(src))
    global HBM_BYTES_PER_S, FP32_FLOP_PER_S, PEAK_OPS_PER_S
    from repro_torch.benchmarks.roofline import (FP32_FLOP_PER_S,
                                                 HBM_BYTES_PER_S,
                                                 PEAK_OPS_PER_S)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fleet_hist as fh
    from repro_torch.kernels import flash_attention, gemm, ssd_scan

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build and device ------------------------------------------------
    t0 = time.perf_counter()
    _build.build(["fleet_hist", "gemm", "ssd_scan", "flash_attention",
                  "flash_bwd", "ssd_bwd"])
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    mesh_cells = start_mesh_cells()
    card = card_name()
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
        "s_not_multiple_of_4_257x2879": ((257, 2879), np.arange(2879) // 10,
                                         288),
        # OFU below the first edge, above the last, and NaN
        "out_of_range_nan_300x640": ((300, 640), np.arange(640) // 10, 64),
    }
    for name, (shape, col, nb) in small.items():
        tpa = rng.uniform(0, 1, shape).astype(np.float32)
        if name == "out_of_range_nan_300x640":
            tpa = rng.uniform(-0.5, 2.0, shape).astype(np.float32)
            tpa.ravel()[rng.choice(tpa.size, 500, replace=False)] = np.nan
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
          f"{rec['max_abs_err']:.3e}, kernel {rec['ms']:.4f} ms "
          f"({rec['bound_ms'] / rec['ms']:.1%} of bound; former kernel "
          f"{OLD_HIST_MS['grid']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    whole = compare_hist(torch, fh, [(torch.cat([g[0] for g in grids]),
                                      torch.cat([g[1] for g in grids]))],
                         b_abs - b_abs[0], int(b_abs[-1] - b_abs[0]) + 1,
                         inv_fmax, reps=5)
    print(f"fleet_hist whole fleet in one call {rows}x"
          f"{grids[0][0].shape[1]}: kernel {whole['ms']:.4f} ms "
          f"({whole['bound_ms'] / whole['ms']:.1%} of bound; former kernel "
          f"{OLD_HIST_MS['fleet']:.4f} ms), plain {whole['plain_ms']:.4f} "
          f"ms, bound {whole['bound_ms']:.4f} ms")
    geo = compare_hist(torch, fh, grids[:1], b_abs - b_abs[0],
                       int(b_abs[-1] - b_abs[0]) + 1, inv_fmax,
                       edges=GEOMETRIC_EDGES)
    print(f"fleet_hist geometric edges (the comparison search decides) "
          f"{ROWS_PER_JOB}x{grids[0][0].shape[1]}: counts bitwise equal, "
          f"max |dsum| {geo['max_abs_err']:.3e}, kernel {geo['ms']:.4f} ms, "
          f"plain {geo['plain_ms']:.4f} ms")
    profile_phases(torch, specs, {"simulate": t1 - t0, "ingest": t2 - t1})

    # -- 5. the serve path: collector -> daemon -> HTTP API -----------------
    serve_launches = serve_phase(torch, dev, specs, card)

    # -- 6-8. the paper's evaluation: scorecard, Table III, acquisition -----
    t0 = time.perf_counter()
    scorecard_launches = scorecard_phase(torch, card)
    table3_launches = table3_phase(torch, dev, card)
    live_launches = live_phase(torch, card)
    print(f"evaluation phases 6-8: {time.perf_counter() - t0:.2f} s")

    kernels = [{"name": "fleet_hist", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fleet_hist.cu",
                "replaces": "src/repro/kernels/fleet_hist.py:79",
                "launches": launches["fleet_hist"], **rec,
                "library_ms": None, "serve_launches": serve_launches,
                "scorecard_launches": scorecard_launches,
                "table3_launches": table3_launches,
                "live_launches": live_launches}]

    # -- 9. the kernel API's kernels vs their plain versions, small ------
    kernel_api_small(torch, dev)

    # -- 10. the kernel API's paths at full model width ---------------------
    kernels += kernel_api_paths(torch, dev, {
        "fleet_hist": fh.ofu_bucket_hist, "gemm": gemm.gemm_padded,
        "ssd_intra": ssd_scan.ssd_intra_kernel,
        "flash_attention": flash_attention.flash_attention_kernel})

    # -- 10b. B3's backward at granite-3-2b's and llama3.2-3b's width -----
    records = {r["name"]: r for r in kernels}
    records["flash_attention"]["backward"] = flash_bwd_phase(torch, dev, card)

    # -- 10c. B4's backward at zamba2-7b-instruct's layer -------------------
    records["ssd_intra"]["backward"] = ssd_bwd_phase(torch, dev, card)
    # phases 12 and 15 count the backward's launches into its record
    records["ssd_intra_bwd"] = records["ssd_intra"]["backward"]

    # -- 11. the model zoo's serving path at full width --------------------
    model_launches, params, measured = model_phase(torch, dev, card, {
        name: records[name]["paths"][SERVE_MODEL]["ms"]
        for name in ("flash_attention", "ssd_intra")})
    for name, n in model_launches.items():
        records[name]["model_launches"] = n

    # -- 12. training at full width, polled for phase 15's train window ------
    poller = CounterPoller(COUNTER_POLL_S)
    train_launches, train_measured, train_window = train_phase(
        torch, dev, card, params, poller)
    measured.update({f"train_{k}": v for k, v in train_measured.items()})
    del params
    for name, n in train_launches.items():
        records[name]["train_launches"] = n

    # -- 13. the paper's benchmark suite and examples on the card ----------
    for name, n in bench_phase(torch, dev, card).items():
        records[name]["bench_launches"] = n

    # -- 14. the ops, the dry run, the roofline and the six CLIs ------------
    records["fleet_hist"]["tools_launches"] = dryrun_phase(
        torch, dev, card, measured, mesh_cells)

    # -- 15. the card's own counters: TPA, SM clock, OFU beside MFU --------
    for name, n in counters_phase(torch, dev, card, poller,
                                  train_window).items():
        records[name]["counters_launches"] = n
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


def compare_hist(torch, fh, grids, col, nb, inv_fmax, reps=1,
                 edges=EDGES) -> dict:
    """The kernel against its plain version on each grid (counts bitwise,
    sums rtol 1e-5), then both timed over the same grids with CUDA events:
    the kernel launch by launch into pre-zeroed outputs, the plain version
    call by call.  Returns the record's measured and bound fields."""
    dev = grids[0][0].device
    err = 0.0
    for tpa, clk in grids:
        h, s = fh.ofu_bucket_hist(tpa, clk, inv_fmax=inv_fmax, edges=edges,
                                  col_bucket=col, n_buckets=nb)
        hp, sp = fh.bucket_hist_torch(tpa, clk, inv_fmax=inv_fmax,
                                      edges=edges, col_bucket=col,
                                      n_buckets=nb)
        torch.cuda.synchronize()
        check(torch.equal(h.long(), hp), "kernel counts differ from the "
              f"plain version at {tuple(tpa.shape)}")
        close = torch.isclose(s, sp, rtol=1e-5, atol=0.0, equal_nan=True)
        check(bool(close.all()), "kernel sums differ from the plain "
              f"version at {tuple(tpa.shape)} beyond rtol 1e-5")
        err = max(err, float((h.long() - hp).abs().max()),
                  float((s - sp).nan_to_num().abs().max()))

    edges_t = torch.from_numpy(np.asarray(edges, np.float32)).to(dev)
    plan, n_slots = fh.plan(col, nb)
    plan_t = torch.from_numpy(plan).to(dev)
    bins = len(edges) - 1
    hist = torch.zeros((len(grids), nb, bins), dtype=torch.int32, device=dev)
    sums = torch.zeros((len(grids), nb), dtype=torch.float64, device=dev)
    # the C call's arguments, made once: the events then time the card,
    # not the wrapper's Python (~0.03 ms a call, as long as one launch)
    launch = fh._kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = [(tpa.data_ptr(), clk.data_ptr(), *tpa.shape,
              fh.rows_per_block(*tpa.shape), plan_t.data_ptr(), n_slots,
              edges_t.data_ptr(), bins, float(np.float32(inv_fmax)),
              hist[i].data_ptr(), sums[i].data_ptr(), dev.index, stream)
             for i, (tpa, clk) in enumerate(grids)]

    def kernel_pass():
        for args in calls:
            rc = launch(*args)
            check(rc == 0, f"fleet_hist launch failed: CUDA error {rc}")

    def plain_pass():
        for tpa, clk in grids:
            fh.bucket_hist_torch(tpa, clk, inv_fmax=inv_fmax, edges=edges,
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


def serve_phase(torch, dev, specs, card: str) -> int:
    """The paper's deployment on the card: one `SimulatorSource` a job
    (the main path's 64 specs, 1,563 devices each, simulating on the
    card) -> `Collector` (1 h rounds into a day-long `WindowedRollup`
    through the histogram kernel) -> `ServiceDaemon` paced by a
    `SimClock` -> `FleetAPIServer` on the loopback, queried with
    `FleetClient`.  Checks the kernel's launches, the regression alerts,
    the rollup's counts against the plain version on every polled grid,
    the alerts of a host replay of the same grids, and the HTTP answers.
    Returns the kernel's launch count over the daemon's run."""
    from repro_torch.fleet.collector import (Collector, CollectorConfig,
                                             JobStream)
    from repro_torch.fleet.jobs import _prep_job
    from repro_torch.fleet.regression import scan_rollup
    from repro_torch.fleet.streaming import precision_label
    from repro_torch.kernels import fleet_hist as fh
    from repro_torch.serve import (FleetAPIServer, FleetClient,
                                   ServiceDaemon, SimClock)
    from repro_torch.serve.store import alert_payload
    from repro_torch.telemetry.scrape import DeviceGrid
    from repro_torch.telemetry.source import GridSource, SimulatorSource

    def streams():
        out = []
        for spec in specs:
            prof, app, _, stragglers, _ = _prep_job(spec, ROWS_PER_JOB)
            src = SimulatorSource(
                prof, duration_s=DAY_S, interval_s=SCRAPE_S,
                chip=spec.chip, events=spec.events, stragglers=stragglers,
                n_devices=ROWS_PER_JOB, seed=spec.seed)
            out.append(JobStream(spec.job_id, src, chips=spec.chips,
                                 group=precision_label(spec.precisions),
                                 app_mfu=app, arch=spec.arch,
                                 chip=spec.chip))
        return out

    cfg = CollectorConfig(round_s=ROUND_S, bucket_s=BUCKET_S,
                          retain=int(DAY_S // BUCKET_S), bins=128,
                          detector=dict(DETECTOR))
    col = Collector(streams(), cfg)
    polled = []                          # (job, round, grid) as polled
    col.on_grid = lambda st, grid: polled.append(
        (st.job_id, col.round_idx, grid))
    walls = {"poll and ingest": 0.0, "of which ingest": 0.0, "detect": 0.0,
             "publish": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            walls[key] += time.perf_counter() - t
            return out
        return run

    col._collect = timed(col._collect, "poll and ingest")
    col.rollup.add_grid = timed(col.rollup.add_grid, "of which ingest")
    col._detect = timed(col._detect, "detect")
    clock = SimClock()
    daemon = ServiceDaemon(col, clock=clock.monotonic, sleep=clock.sleep)
    daemon.store.update_from = timed(daemon.store.update_from, "publish")
    try:
        server = FleetAPIServer(daemon.store, host="127.0.0.1", port=0)
    except OSError as e:
        fail(f"serve: cannot bind a loopback socket: {e}")
    server.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fh.ofu_bucket_hist.launches = 0
        t0 = time.perf_counter()
        reports = daemon.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fh.ofu_bucket_hist.launches
        peak = torch.cuda.max_memory_allocated(dev)
        n_rounds = len(reports)
        samples = sum(r.samples for r in reports)
        print(f"serve: {card}: {n_rounds} rounds of {ROUND_S:.0f} s, "
              f"{len(specs)} jobs x {ROWS_PER_JOB} devices, the day "
              f"({DAY_S:.0f} s) uncut; {samples} samples; "
              f"wall {wall:.3f} s ({wall / max(n_rounds, 1):.4f} s a "
              "round): " + ", ".join(f"{k} {v:.3f} s ({v / n_rounds:.4f} "
                                     "s a round)" for k, v in walls.items())
              + f"; peak device memory {peak / 2**30:.3f} GiB; "
              f"fleet_hist launches {launches}")

        # -- checks ---------------------------------------------------------
        want_rounds = int(DAY_S // ROUND_S)
        check(n_rounds == want_rounds and daemon.overruns == 0,
              f"serve: {n_rounds} rounds ({daemon.overruns} overruns), "
              f"expected {want_rounds}")
        check(launches >= len(specs) * want_rounds,
              f"serve: the histogram kernel launched {launches} times for "
              f"{len(specs)} jobs x {want_rounds} rounds")
        check(len(polled) == len(specs) * want_rounds
              and all(g.tpa.is_cuda for _, _, g in polled),
              "serve: the polled grids are not one on the card a job and "
              "round")
        regressed = {a.job_id for a in col.alerts if a.kind == "regression"}
        check(regressed == {SLOW_JOB},
              f"serve: regression alerts for {sorted(regressed)}, expected "
              f"only {SLOW_JOB}")
        (reg,) = scan_rollup(col.rollup, jobs=[SLOW_JOB],
                             **DETECTOR)[SLOW_JOB]
        start = col.rollup.bucket0 + reg.start_idx
        fired = next(a for a in col.alerts if a.kind == "regression")
        print(f"serve: {SLOW_JOB} regression alert at round "
              f"{fired.round_idx} ({fired.message}); episode starts at "
              f"bucket {start}")
        check(abs(start - 144) <= 6 and reg.factor > 1.5,
              f"serve: regression of {SLOW_JOB} misplaced: {reg}")
        others = {}
        for a in col.alerts:
            if a.kind != "regression":
                others.setdefault(a.kind, []).append(a.job_id)
        print("serve: other alerts by kind: "
              + ("; ".join(f"{k}: {', '.join(sorted(v))}"
                           for k, v in sorted(others.items())) or "none"))
        check_serve_counts(torch, fh, col, polled)

        # the same grids on the host, replayed into a second collector
        t1 = time.perf_counter()
        by_job = {}
        for jid, _, g in polled:
            by_job.setdefault(jid, []).append(g)
        host = []
        for st in col.streams:
            gs = by_job[st.job_id]
            host.append(JobStream(st.job_id, GridSource(DeviceGrid(
                SCRAPE_S, torch.cat([g.tpa for g in gs], 1).cpu().numpy(),
                torch.cat([g.clock_mhz for g in gs], 1).cpu().numpy())),
                chips=st.chips, group=st.group, app_mfu=st.app_mfu,
                arch=st.arch, chip=st.chip))
        replay = Collector(host, cfg)
        replay.run()
        keys = [(a.round_idx, a.job_id, a.kind) for a in col.alerts]
        check(keys == [(a.round_idx, a.job_id, a.kind)
                       for a in replay.alerts],
              "serve: the host replay's alerts differ from the card's")
        print(f"serve: host replay of the same grids through GridSources: "
              f"{len(keys)} alerts equal by (round, job, kind) "
              f"({time.perf_counter() - t1:.2f} s)")

        # the HTTP API
        client = FleetClient(server.url)
        lat = []

        def get(fn, *a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            lat.append(time.perf_counter() - t)
            return out

        fleet = get(client.fleet)
        check(fleet["round_idx"] == n_rounds and fleet["scope"] == "fleet"
              and len(fleet["mean"]) == cfg.retain
              and fleet["weighted_ofu"] is not None,
              f"serve: /v1/fleet answered {str(fleet)[:200]}")
        job = get(client.job, SLOW_JOB)
        check(job["id"] == SLOW_JOB and len(job["mean"]) == cfg.retain
              and job["meta"]["chips"] == 2048,
              f"serve: /v1/jobs/{SLOW_JOB} answered {str(job)[:200]}")
        alerts = get(client.alerts)
        check(alerts["alerts"] == [alert_payload(a) for a in col.alerts],
              "serve: /v1/alerts differs from the collector's alerts")
        top = get(client.top_regressions, k=3, **DETECTOR)
        check(top["regressions"]
              and top["regressions"][0]["job_id"] == SLOW_JOB,
              f"serve: top regressions {top['regressions']}")
        again = get(client.fleet)
        check(client.hits_304 == 1 and again == fleet,
              f"serve: repeated /v1/fleet gave {client.hits_304} 304s")
        print(f"serve: {card}: HTTP 4 GETs answered 200 and a repeat 304; "
              f"median GET latency {1e3 * float(np.median(lat)):.3f} ms "
              f"(of {len(lat)}: " + ", ".join(f"{1e3 * x:.3f}" for x in lat)
              + " ms)")
    finally:
        server.stop()
        daemon.close()
    del polled
    torch.cuda.empty_cache()
    profile_serve(torch, Collector(streams(), cfg))
    return launches


def profile_serve(torch, col, rounds: int = 2,
                  label: str = "serve") -> None:
    """Device busy time of collector rounds, from torch.profiler over a
    fresh collector's rounds after one warm-up round (the timed run
    carries no profiler cost): the device's idle share and the host ops
    that hold the most time (a `.cpu()` that waits on the card counts as
    its copy's host time)."""
    from torch.profiler import ProfilerActivity, profile
    col.poll_round()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            col.poll_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev, _ = device_times(ev)
    busy_s = sum(d for d, _, _ in dev) / 1e6
    host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in ev),
                  reverse=True)[:5]
    top = "; ".join(f"{k[:40]} {us / 1e3:.1f} ms x{n}" for us, n, k in host)
    if busy_s <= 0:
        print(f"profile {label}: device time not measured (the profiler "
              "saw no device activity)")
        return
    print(f"profile {label}: {rounds} rounds under the profiler: device busy "
          f"{busy_s:.4f} s of {wall:.4f} s wall (idle share "
          f"{1 - busy_s / wall:.3f}), {sum(n for _, n, _ in dev)} kernels; "
          f"top host self time: {top}")


def scorecard_phase(torch, card: str) -> int:
    """The labelled-incident scorecard on the card: `run_scorecard` at the
    reference's geometry (8 scenarios, 2 h of 30 s scrapes, 300 s rounds,
    4 sampled devices a job), the histogram kernel ingesting every
    replayed grid.  Checks every pinned floor, the kernel's launches
    against the (job, round) grids that hold samples, and that a replay
    of the same grids from the host fires the same alerts.  Returns the
    kernel's launch count over `run_scorecard`."""
    from dataclasses import replace

    from repro_torch.kernels import fleet_hist as fh
    from repro_torch.scenarios import (build, check_floors, scenario_names,
                                       scorecard)
    from repro_torch.telemetry.scrape import DeviceGrid

    # one grid a (job, round) with samples: the collector's right-closed
    # rounds over each job's scrape instants
    want = 0
    for name in scenario_names():
        sc = build(name)
        for spec in sc.specs:
            n = int(spec.duration_s // spec.scrape_interval_s)
            t = spec.scrape_interval_s * np.arange(1, n + 1)
            want += np.unique(np.ceil(t / sc.round_s) - 1).size
    runs = []
    run_scenario, simulate_fleet = scorecard.run_scenario, \
        scorecard.simulate_fleet

    def recorded(sc, **kw):             # keeps each run's grids
        runs.append(run_scenario(sc, **kw))
        return runs[-1]

    scorecard.run_scenario = recorded
    try:
        torch.cuda.synchronize()
        fh.ofu_bucket_hist.launches = 0
        t0 = time.perf_counter()
        doc = scorecard.run_scorecard()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fh.ofu_bucket_hist.launches
    finally:
        scorecard.run_scenario = run_scenario
    bad = check_floors(doc)
    n_alerts = sum(e["n_alerts"] for e in doc["scenarios"].values())
    print(f"scorecard: {card}: {len(doc['scenarios'])} scenarios, "
          f"{sum(len(r.telemetry) for r in runs)} jobs x 4 devices, "
          f"engine {doc['engine']} on the card; {n_alerts} alerts; "
          f"{wall:.3f} s; fleet_hist launches {launches} (non-empty (job, "
          f"round) grids {want}); floors violated: {bad or 'none'}")
    check(doc["engine"] == "torch" and all(
        r.telemetry[0].grid.tpa.is_cuda for r in runs),
        "scorecard: the scenarios did not simulate on the card")
    check(not bad, f"scorecard: floors violated on the card: {bad}")
    check(launches == want, f"scorecard: the histogram kernel launched "
          f"{launches} times for {want} non-empty (job, round) grids")

    # the same grids from the host (CPU tensors: the plain version ingests)
    t0 = time.perf_counter()
    for run in runs:
        host = [replace(t, grid=DeviceGrid(
            t.grid.interval_s, t.grid.tpa.cpu(), t.grid.clock_mhz.cpu(),
            t0_s=t.grid.t0_s)) for t in run.telemetry]
        scorecard.simulate_fleet = lambda specs, **kw: host
        try:
            again = scorecard.run_scenario(run.scenario, device="cpu")
        finally:
            scorecard.simulate_fleet = simulate_fleet
        # the factors carry the bucket means, equal to rounding
        check([(a.round_idx, a.t_s, a.job_id, a.kind) for a in again.alerts]
              == [(a.round_idx, a.t_s, a.job_id, a.kind) for a in run.alerts]
              and np.allclose([a.factor for a in again.alerts],
                              [a.factor for a in run.alerts], rtol=1e-5,
                              atol=0.0, equal_nan=True),
              f"scorecard: {run.scenario.name}: the host replay's alerts "
              "differ from the card's")
    print(f"scorecard: host replay of the same grids through GridSources: "
          f"{n_alerts} alerts equal ({time.perf_counter() - t0:.2f} s)")
    golden = Path(__file__).resolve().parent / "tests" / "data" \
        / "golden_scorecard.json"
    ref = json.loads(golden.read_text())["scenarios"]
    def fmt(d):
        ttd = "-" if d["ttd_s"] is None else f"{d['ttd_s']:.0f} s"
        return f"P {d['precision']:.3f} R {d['recall']:.3f} ttd {ttd}"

    print("scorecard (scenario/detector): card | reference, the golden "
          "document (fused engine, CPU)")
    for name, entry in doc["scenarios"].items():
        for det, d in entry["detectors"].items():
            print(f"  {name}/{det}: {fmt(d)} | "
                  f"{fmt(ref[name]['detectors'][det])}")
    return launches


def table3_phase(torch, dev, card: str) -> int:
    """The paper's Table III / Fig. 5 fleet at every GPU on the card: 608
    jobs, 389,744 devices x 40 samples (`table3.build_jobs(max_devices=
    5888)`), batch-ingested through the histogram kernel (one launch a
    job), analysed by `divergence.analyze` and `analyze_correlation`,
    then replayed live through a `Collector` (4 rounds of one bucket,
    one launch a job and round) into `FleetStore` and the HTTP API.
    Holds the reference tool's self-check: the flagged set is exactly
    the 82 `naive_moe` and `naive_hybrid` jobs on both detectors and in
    the live miscalc alerts, r after exclusion >= 0.75, live per-job
    bucket counts equal to the offline ones.  Returns the kernel's launch
    count over the phase."""
    from repro_torch.fleet import table3
    from repro_torch.fleet.collector import Collector, CollectorConfig
    from repro_torch.fleet.correlation import analyze_correlation
    from repro_torch.fleet.divergence import analyze
    from repro_torch.kernels import fleet_hist as fh
    from repro_torch.serve import FleetAPIServer, FleetClient, FleetStore

    walls = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)    # earlier phases' tensors
    fh.ofu_bucket_hist.launches = 0
    t0 = time.perf_counter()
    jobs = table3.build_jobs(max_devices=TABLE3_DEVICES)
    torch.cuda.synchronize()
    walls["simulate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    roll, mfu = table3.offline_rollups(jobs)
    torch.cuda.synchronize()
    walls["ingest"] = time.perf_counter() - t0
    offline = fh.ofu_bucket_hist.launches
    t0 = time.perf_counter()
    rep = analyze(roll.to_job_points(), flag_rel_err=table3.FLAG_REL_ERR)
    crep = analyze_correlation(mfu, roll)
    walls["analyze"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    col = Collector(table3.to_streams(jobs),
                    CollectorConfig(round_s=table3.ROUND_S,
                                    bucket_s=table3.BUCKET_S,
                                    flag_rel_err=table3.FLAG_REL_ERR))
    reports = col.run()
    torch.cuda.synchronize()
    walls["live replay"] = time.perf_counter() - t0
    launches = fh.ofu_bucket_hist.launches
    peak = torch.cuda.max_memory_allocated(dev)

    n_dev = sum(j.telemetry.grid.n_devices for j in jobs)
    n_s = {j.telemetry.grid.tpa.shape[1] for j in jobs}
    want_dev = sum(chips * n for chips, n in table3.SCALE_MIX)
    print(f"table3: {card}: {len(jobs)} jobs, {n_dev} devices x {n_s} "
          f"samples ({n_dev * max(n_s)} samples); "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; {len(reports)} live rounds; peak device memory "
          f"{(peak - base) / 2**30:.3f} GiB over the {base / 2**30:.3f} GiB "
          f"held before; fleet_hist launches {offline} offline, "
          f"{launches - offline} live")
    check(len(jobs) == 608 and n_dev == want_dev and n_s == {40},
          f"table3: {len(jobs)} jobs, {n_dev} devices x {n_s} samples, "
          f"expected 608, {want_dev} x 40")
    check(all(j.telemetry.grid.tpa.is_cuda for j in jobs),
          "table3: the grids are not on the card")
    check(offline == len(jobs) and launches - offline == len(jobs) * 4
          and len(reports) == 4,
          f"table3: the histogram kernel launched {offline} times offline "
          f"and {launches - offline} live over {len(reports)} rounds, "
          f"expected {len(jobs)} and {len(jobs) * 4}")
    check_counts(torch, fh, roll, [(j.job_id, j.telemetry.grid)
                                   for j in jobs],
                 {j.job_id: j.spec.chips for j in jobs},
                 {j.job_id: 1.0 / j.spec.chip.f_max_mhz for j in jobs},
                 "table3 offline")

    truth = table3.affected_ids(jobs)
    affected = set().union(*truth.values())
    flagged = {p.job_id for p in rep.flagged}
    cflagged = {f.job_id for f in crep.flagged}
    print(f"table3 divergence: r_all {rep.r_all:.6f} r_after_exclusion "
          f"{rep.r_clean:.6f} mae {rep.mae_all:.6f} flagged {len(flagged)} "
          f"exact_match {flagged == affected}; correlation: r_all "
          f"{crep.r_all:.6f} r_after_exclusion {crep.r_clean:.6f} mae "
          f"{crep.mae:.6f} flagged {len(cflagged)} exact_match "
          f"{cflagged == affected}; affected "
          f"{ {k: len(v) for k, v in sorted(truth.items())} }")
    for chips, (n, mfu_pct, err) in sorted(rep.by_scale.items()):
        print(f"table3.gpus={chips} jobs={n} mfu={mfu_pct * 100:.1f}% "
              f"abs_err={err * 100:.1f}pp")
    check(len(affected) == 82, f"table3: {len(affected)} affected jobs")
    check(flagged == affected and cflagged == affected,
          f"table3: flagged {len(flagged)} (divergence) and {len(cflagged)} "
          f"(correlation), expected exactly the {len(affected)} affected; "
          f"extra {sorted((flagged | cflagged) - affected)[:5]}, missing "
          f"{sorted(affected - (flagged & cflagged))[:5]}")
    check(crep.r_clean >= 0.75 and rep.r_clean >= 0.75,
          f"table3: r after exclusion {rep.r_clean:.3f} / "
          f"{crep.r_clean:.3f} < 0.75")

    # the live half, as the reference tool's self-check holds it, but for
    # the bucket means: B1's sums land by atomics in no fixed order, so a
    # job's one offline launch and its four live ones agree to rounding
    # (rtol 1e-5), where the host path's sums are equal by construction
    miscalc = {a.job_id for a in col.alerts if a.kind == "miscalc"}
    check(miscalc == affected, f"table3: live miscalc alerts name "
          f"{len(miscalc)} jobs, expected the {len(affected)} affected")
    rel = 0.0
    for job in jobs:
        key = ("job", job.job_id)
        n = roll._hists[key].shape[0]
        so = roll.job_stats(job.job_id)
        sl = col.rollup.job_stats(job.job_id)
        check(np.array_equal(roll._hists[key], col.rollup._hists[key][:n])
              and np.array_equal(so.weight, sl.weight[:n])
              and all(np.array_equal(so.percentiles[q],
                                     sl.percentiles[q][:n], equal_nan=True)
                      for q in so.percentiles),
              f"table3: {job.job_id}: live counts differ from offline")
        check(np.allclose(so.mean, sl.mean[:n], rtol=1e-5, atol=0.0,
                          equal_nan=True),
              f"table3: {job.job_id}: live OFU bucket means beyond rtol "
              "1e-5 of offline")
        rel = max(rel, float(np.nanmax(np.abs(so.mean - sl.mean[:n])
                                       / so.mean)))
        io_, vo = mfu.job_series(job.job_id)
        il, vl = col.mfu.job_series(job.job_id)
        check(np.array_equal(io_, il) and np.array_equal(vo, vl),
              f"table3: {job.job_id}: live MFU buckets differ from offline")
    store = FleetStore()
    store.update_from(col)
    with FleetAPIServer(store, host="127.0.0.1", port=0) as server:
        client = FleetClient(server.url)
        div = client.divergence(flag_rel_err=table3.FLAG_REL_ERR)
        corr = client.correlation()
    check({f["job_id"] for f in div["flagged"]} == affected
          and {f["job_id"] for f in corr["flagged"]} == affected,
          "table3: the served flagged sets differ from the affected jobs")
    dr = 0.0
    for name, live, off in [("divergence r_all", div["r_all"], rep.r_all),
                            ("divergence r_clean", div["r_clean"],
                             rep.r_clean),
                            ("correlation r_all", corr["r_all"], crep.r_all),
                            ("correlation r_clean", corr["r_clean"],
                             crep.r_clean)]:
        check(abs(live - off) < 1e-5, f"table3: served {name} {live} is "
              f"not within 1e-5 of offline {off}")
        dr = max(dr, abs(live - off))
    print(f"table3 live: {len(jobs)} jobs x {len(reports)} rounds through "
          f"a Collector, FleetStore and the HTTP API: miscalc alerts, "
          f"served divergence and correlation flag exactly the "
          f"{len(affected)} affected; per-job counts, weights, percentiles "
          f"and MFU buckets equal offline, OFU bucket means within "
          f"{rel:.2e} (rel); served r_after_exclusion {corr['r_clean']:.6f}, "
          f"max |r live - r offline| {dr:.2e}")
    profile_serve(torch, Collector(table3.to_streams(jobs), CollectorConfig(
        round_s=table3.ROUND_S, bucket_s=table3.BUCKET_S,
        flag_rel_err=table3.FLAG_REL_ERR)), label="table3 live")
    return launches


def live_phase(torch, card: str) -> int:
    """The acquisition tier, one DGX H100 node's worth: 8 GPUs whose
    counters are SIMULATED on the card (`FakeDcgmTransport`, 1 h of 30 s
    scrapes, 2.5x slowdown from 1,800 s) -> `make_dcgm_backends` ->
    `BackendSource` -> `Collector` -> `ServiceDaemon` -> `FleetAPIServer`.
    Holds the reference tool's self-check: healthy backends with every
    poll made, the regression alert served, the served series bitwise
    equal to the simulator's host-copied chunks replayed the same way,
    and injected transport faults sample-transparent.  Then the
    simulator's card grids, ingested by the histogram kernel, against
    the live path: the same alerts, series within rtol 1e-5, counts
    apart by at most the samples that lie within 4 f32 ulps of a bin
    edge.  Returns the kernel's launch count over the phase."""
    import importlib.util
    import shutil

    from repro_torch.fleet.collector import (Collector, CollectorConfig,
                                             JobStream)
    from repro_torch.kernels import fleet_hist as fh
    from repro_torch.serve import (FleetAPIServer, FleetClient,
                                   ServiceDaemon, SimClock)
    from repro_torch.telemetry.backends import (FakeDcgmTransport,
                                                make_dcgm_backends)
    from repro_torch.telemetry.counters import Event, StepProfile
    from repro_torch.telemetry.scrape import DeviceGrid
    from repro_torch.telemetry.source import (BackendSource, GridSource,
                                              SimulatorSource)

    print(f"live: dcgmi on PATH: {shutil.which('dcgmi') is not None}; "
          f"pynvml importable: "
          f"{importlib.util.find_spec('pynvml') is not None}")
    profile = StepProfile(mxu_time_s=0.84, step_time_s=2.0)
    n_dev, interval, duration, round_s, seed = 8, 30.0, 3600.0, 300.0, 7
    events = [Event(1800, 3600, slowdown=2.5)]
    cfg = CollectorConfig(round_s=round_s, bucket_s=round_s, retain=12,
                          detector={"window": 3, "min_duration": 1})

    def serve(source):
        clk = SimClock()
        col = Collector([JobStream("live", source)], cfg)
        daemon = ServiceDaemon(col, clock=clk.monotonic, sleep=clk.sleep)
        with daemon, FleetAPIServer(daemon.store, host="127.0.0.1",
                                    port=0) as server:
            daemon.run()
            client = FleetClient(server.url)
            return (client.fleet(), client.job("live"), client.alerts(),
                    col)

    def live(fail_every=None):
        transport = FakeDcgmTransport(
            profile, duration_s=duration, interval_s=interval,
            n_devices=n_dev, chunk_s=round_s, events=events, seed=seed,
            fail_every=fail_every)
        backends = make_dcgm_backends(transport, n_dev,
                                      sleep=lambda s: None)
        return backends, BackendSource(backends=backends,
                                       duration_s=duration,
                                       interval_s=interval)

    def sim():
        return SimulatorSource(profile, duration_s=duration,
                               interval_s=interval, n_devices=n_dev,
                               seed=seed, events=events)

    torch.cuda.synchronize()
    fh.ofu_bucket_hist.launches = 0
    t0 = time.perf_counter()
    backends, src = live()
    fleet, job, alerts, lcol = serve(src)
    wall = time.perf_counter() - t0
    polls = sum(b.polls for b in backends)
    check(all(b.healthy for b in backends)
          and polls == n_dev * duration / interval,
          f"live: {sum(b.healthy for b in backends)}/{n_dev} backends "
          f"healthy, {polls} polls")
    reg = next((a for a in alerts["alerts"] if a["kind"] == "regression"),
               None)
    check(reg is not None, f"live: no regression alert served: {alerts}")

    # the simulator's card chunks at the same cadence, copied to host
    # float64 once and replayed through a GridSource
    s = sim()
    chunks = [s.poll(round_s) for _ in range(int(duration // round_s))]
    check(all(c.tpa.is_cuda for c in chunks),
          "live: the simulator's chunks are not on the card")
    host = DeviceGrid(interval, *(np.concatenate(
        [getattr(c, k).cpu().numpy().astype(np.float64) for c in chunks],
        axis=1) for k in ("tpa", "clock_mhz")))
    r_fleet, r_job, r_alerts, _ = serve(GridSource(host))
    check((fleet, job, alerts) == (r_fleet, r_job, r_alerts),
          "live: the served series differ from the host replay's")
    flaky, fsrc = live(fail_every=97)
    f_fleet, f_job, _, _ = serve(fsrc)
    retries = sum(b.retries for b in flaky)
    check(retries > 0 and all(b.healthy for b in flaky)
          and (f_fleet, f_job) == (fleet, job),
          f"live: injected faults ({retries} retries) changed the served "
          "samples")

    # the card path: the simulator's grids, ingested by the kernel
    c_fleet, c_job, c_alerts, ccol = serve(sim())
    launches = fh.ofu_bucket_hist.launches
    keys = ("round_idx", "t_s", "job_id", "kind")
    check([[a[k] for k in keys] for a in c_alerts["alerts"]]
          == [[a[k] for k in keys] for a in alerts["alerts"]]
          and np.allclose([a["factor"] for a in c_alerts["alerts"]],
                          [a["factor"] for a in alerts["alerts"]],
                          rtol=1e-5, atol=0.0),
          "live: the card path's alerts differ from the live path's")
    moved = float(np.abs(ccol.rollup._hists[("job", "live")]
                         - lcol.rollup._hists[("job", "live")]).sum()) / 2
    ofu = host.tpa * host.clock_mhz / lcol.streams[0].chip.f_max_mhz
    e32 = lcol.rollup.edges.astype(np.float32)
    k = np.clip(np.searchsorted(e32.astype(np.float64), ofu), 1,
                len(e32) - 1)
    near = np.minimum(np.abs(ofu - e32[k - 1]) / np.spacing(e32[k - 1]),
                      np.abs(ofu - e32[k]) / np.spacing(e32[k]))
    n_near = int((near <= 4).sum())
    rel = 0.0
    for got, want in ((c_fleet, fleet), (c_job, job)):
        check(got["t_s"] == want["t_s"] and got["weight"] == want["weight"]
              and np.allclose(got["mean"], want["mean"], rtol=1e-5,
                              atol=0.0),
              "live: the card path's series differ beyond rtol 1e-5")
        rel = max(rel, float(np.max(np.abs(np.subtract(got["mean"],
                                                       want["mean"]))
                                    / np.abs(want["mean"]))))
    check(moved <= n_near, f"live: {moved:.0f} samples changed bins "
          f"between card and host ingest, more than the {n_near} within "
          "4 f32 ulps of an edge")
    check(launches == int(duration // round_s), f"live: the histogram "
          f"kernel launched {launches} times for the card path's "
          f"{int(duration // round_s)} rounds")
    print(f"live: {card}: SIMULATED counters (FakeDcgmTransport on the "
          f"card) -> {n_dev} DcgmFieldBackends -> BackendSource -> "
          f"Collector -> ServiceDaemon -> HTTP: {polls} polls, all healthy, "
          f"{len(fleet['t_s'])} buckets served bitwise equal to the host "
          f"replay of the simulator's chunks; regression alert "
          f"'{reg['message']}'; fail_every=97: {retries} "
          f"retries, samples unchanged; card ingest (fleet_hist launches "
          f"{launches}): alerts equal, series max rel diff {rel:.2e}, "
          f"{moved:.0f} samples moved bins ({n_near} within 4 f32 ulps of "
          f"an edge); {wall:.3f} s the live run")
    return launches


def check_serve_counts(torch, fh, col, polled) -> None:
    """The rollup against the plain version on every grid the daemon
    polled: each (job, bucket) row of counts bitwise (a bucket is filled
    by one round, as count x weight), sums at rtol 1e-5."""
    chips = {st.job_id: st.chips for st in col.streams}
    inv_fmax = {st.job_id: 1.0 / st.chip.f_max_mhz for st in col.streams}
    check_counts(torch, fh, col.rollup, [(jid, g) for jid, _, g in polled],
                 chips, inv_fmax, "serve")


def check_counts(torch, fh, roll, grids, chips: dict, inv_fmax: dict,
                 label: str) -> None:
    """The rollup's job rows against the plain version on each (job, grid)
    it ingested: counts bitwise (as count x weight; each grid fills its
    own buckets), sums at rtol 1e-5."""
    err = 0.0
    for jid, g in grids:
        b_abs = np.maximum(np.ceil(g.times_s / roll.bucket_s).astype(int)
                           - 1, 0)
        b0, nb = int(b_abs[0]), int(b_abs[-1] - b_abs[0]) + 1
        hist, sums = fh.bucket_hist_torch(
            g.tpa, g.clock_mhz, inv_fmax=inv_fmax[jid], edges=roll.edges,
            col_bucket=b_abs - b0, n_buckets=nb)
        w = chips[jid] / g.n_devices
        rows = slice(b0 - roll.bucket0, b0 - roll.bucket0 + nb)
        check(np.array_equal(roll._hists[("job", jid)][rows],
                             hist.cpu().numpy().astype(float) * w),
              f"{label}: {jid} counts at buckets {b0}-{b0 + nb - 1} differ "
              "from the plain version's")
        want = sums.cpu().numpy() * w
        got = roll._sums[("job", jid)][rows]
        check(np.allclose(got, want, rtol=1e-5, atol=0.0),
              f"{label}: {jid} sums at buckets {b0}-{b0 + nb - 1} beyond "
              "rtol 1e-5 of the plain version's")
        err = max(err, float(np.abs(got - want).max()))
    print(f"{label}: rollup against the plain version on {len(grids)} "
          f"ingested grids: counts bitwise equal, max |dsum| {err:.3e}")


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
        dev, _ = device_times(prof.key_averages())
        busy_s = sum(d[0] for d in dev) / 1e6
        if not dev:
            print(f"profile {phase}: device time not measured (the profiler "
                  "saw no device activity)")
            continue
        print(f"profile {phase}: device busy {busy_s:.4f} s of "
              f"{walls[phase]:.4f} s wall (idle share "
              f"{1 - busy_s / walls[phase]:.3f}), "
              f"{sum(d[1] for d in dev)} kernels; top: {top_times(dev, 4)}")


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


# ---------------------------------------------------------------------------
# the kernel API: GEMM, SSD intra-chunk, flash attention
# ---------------------------------------------------------------------------
def close(torch, name: str, got, want, rtol: float, atol: float) -> float:
    """Fails unless got and want have one shape, got is finite and
    |got - want| <= atol + rtol·|want| everywhere (bitwise when both are
    0); returns max |got - want|."""
    check(tuple(got.shape) == tuple(want.shape),
          f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    g, w = got.double(), want.double()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    mx = float(err.max()) if err.numel() else 0.0
    check(bool((err <= atol + rtol * w.abs()).all()),
          f"{name}: kernel differs from its plain version (max |diff| "
          f"{mx:.3e} beyond rtol {rtol}, atol {atol})")
    return mx


def close_rows(torch, name: str, got, want, mutants: dict) -> float:
    """The full-width bf16 check: fails unless got has want's shape, is
    finite and |got - want| <= 2^-6·|want| + 2^-5·rms everywhere, rms the
    RMS of want's row along its last dim (the elements of a row that
    cancel to near 0 carry the rounding error of the whole row); and
    unless that limit rejects each of `mutants` (name -> a wrong output),
    so that it is seen to catch a zeroed or tile-dropping kernel.
    Prints the typical |want| beside max |diff|; returns max |diff|."""
    check(tuple(got.shape) == tuple(want.shape),
          f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    w = want.double()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    limit = BF16_RTOL * w.abs() + BF16_ROW_ATOL * rms

    def beyond(t):
        return (t.double() - w).abs() > limit

    mx = float((got.double() - w).abs().max())
    n_bad = int(beyond(got).sum())
    check(n_bad == 0, f"{name}: {n_bad} elements differ from the plain "
          f"version beyond rtol 2^-6 + 2^-5 of the row RMS (max |diff| "
          f"{mx:.3e})")
    caught = []
    for what, t in mutants.items():
        n = int(beyond(t).sum())
        check(n > 0, f"{name}: the limit passes a {what} output")
        caught.append(f"{what} {n:,d}")
    print(f"{name}: max |diff| {mx:.3e}, median |out| "
          f"{float(w.abs().median()):.3e}, row RMS {float(rms.min()):.3e} "
          f"to {float(rms.max()):.3e}; the limit rejects, of "
          f"{w.numel():,d} elements: " + ", ".join(caught))
    return mx


#: `close_summands`' limits: |got - want| <= a·|want| + b·σ + c·RMS(want)
#: element by element and RMS(got - want) <= d·RMS(want), as (a, b, c, d).
#: A bf16 backward's gradient: the kernels round a factor to bf16 before
#: its product (2^-9 of each summand, which the summands' cancellation
#: does not shrink), the RMS term the f32 cancellation where the gradient
#: is 0, and the whole within 1e-2 (the card read 1.7e-3 to 2.5e-3).
BWD_TOL = (2 ** -6, 2 ** -5, 2 ** -12, 1e-2)
#: The SSD backward's d dt and d dacs: f32 sums of f32 products of f32
#: tensor-core products of bf16 operands, rounded nowhere, so they differ
#: from the f32 plain version only in the order of f32 additions (the
#: card read at most 3.5e-5·σ and a relative RMS of 4.6e-7 at
#: zamba2-7b-instruct's layer, 1.7e-6 at the gpu tests' shapes); a
#: backward that summed dM or M rounded to bf16 reads ~1e-3 of both.
F32_SUM_TOL = (0.0, 2 ** -12, 2 ** -20, 1e-5)


def close_summands(torch, name: str, got, want, sigma, mutants: dict,
                   tol: tuple = BWD_TOL) -> tuple[float, float]:
    """A backward's check: fails unless got has want's shape, is finite,
    |got - want| <= a·|want| + b·σ + c·RMS(want) everywhere, σ each
    element's summands' root-sum-square (`ref.flash_bwd_scales`,
    `ref.ssd_bwd_scales`), and RMS(got - want) <= d·RMS(want), (a, b, c,
    d) = `tol` (`BWD_TOL`, `F32_SUM_TOL`); and unless the check rejects
    each of `mutants`, by either part.  Prints max |diff| over σ and each
    verdict; returns max |diff| and the relative RMS."""
    check(tuple(got.shape) == tuple(want.shape),
          f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    a, b, c, rel_max = tol
    w = want.double()
    rms = float(w.pow(2).mean().sqrt())
    limit = a * w.abs() + b * sigma.double() + c * rms

    def verdict(t):
        d = t.double() - w
        return int((d.abs() > limit).sum()), \
            float(d.pow(2).mean().sqrt()) / rms

    diff = (got.double() - w).abs()
    mx = float(diff.max())
    n_bad, rel = verdict(got)
    check(n_bad == 0, f"{name}: {n_bad} elements differ from the plain "
          f"version beyond {a:.3g} of it + {b:.3g} of its summands' "
          f"root-sum-square + {c:.3g} of its RMS (max |diff| {mx:.3e})")
    check(rel <= rel_max, f"{name}: the difference's RMS is {rel:.3e} "
          f"of the plain version's, past {rel_max}")
    caught = []
    for what, t in mutants.items():
        n, r = verdict(t)
        check(n > 0 or r > rel_max,
              f"{name}: the check passes a {what} output")
        caught.append(f"{what} ({n:,d} elements, relative RMS {r:.3e})")
    sg = sigma.double()
    per = float((diff / sg)[sg > 2 ** -12 * rms].max())
    print(f"{name}: max |diff| {mx:.3e}, at most {per:.3e} of an element's "
          f"summands' root-sum-square (limit {b:.3g}), relative RMS "
          f"{rel:.3e} (limit {rel_max}), RMS {rms:.3e}; the check rejects, "
          f"of {w.numel():,d} elements: " + ", ".join(caught))
    return mx, rel


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: bytes over the data sheet's
    HBM rate or operations over its peak for the input type, the larger."""
    b = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
         "operations": n_ops / PEAK_OPS_PER_S[kind] * 1e3}
    by = max(b, key=b.get)
    return {"bound_ms": b[by], "bound_by": by}


def kernel_api_small(torch, dev) -> None:
    """Each kernel of the kernel API, through its public entry point, on
    the card against its plain version there, at the JAX tests' shapes
    and tolerances (GEMM rtol 1e-3/atol 1e-4 f32, 0.2/2e-2 bf16, int8
    exact; flash 1e-3 f32, 5e-2 bf16; SSD 1e-3), plus ragged flash
    shapes (Sk = 200, which the reference's 64-key blocks do not divide,
    and Sq = 100) that must launch the kernel, and bf16 SSD shapes that
    must launch the wgmma kernel (held with `close_rows`)."""
    from repro_torch.core.tile_quant import TilePolicy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm, ops
    from repro_torch.kernels.ref import (ref_attention, ref_matmul,
                                         ref_ssd_intra)
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    rng = np.random.default_rng(42)

    def arr(shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale) \
            .to(dtype).to(dev)

    def gemm_case(x, y, pol, rtol, atol, name):
        f0 = gemm.gemm_padded.launched_flops
        out, prof = ops.matmul(x, y, policy=pol)
        check(gemm.gemm_padded.launched_flops - f0 == prof.profiled_flops,
              f"{name}: launched FLOPs differ from the profile")
        return close(torch, name, out, ref_matmul(x, y), rtol, atol), prof

    errs = {}
    for M, N, K in GEMM_SHAPES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            name = f"gemm {M}x{N}x{K} {dtype}"
            err, _ = gemm_case(arr((M, K), dtype), arr((K, N), dtype),
                               TilePolicy(128, 128, 128), tol * 10, tol,
                               name)
            errs[str(dtype)] = max(errs.get(str(dtype), 0.0), err)
    for (M, N, K), tiles in TC_GEMM_SHAPES:
        name = f"gemm {M}x{N}x{K} bf16 tiles {tiles}"
        n0 = gemm.gemm_padded.launches_by["wgmma_bf16"]
        err, prof = gemm_case(arr((M, K), torch.bfloat16),
                              arr((K, N), torch.bfloat16),
                              TilePolicy(*tiles), 0.2, 2e-2, name)
        check(gemm.gemm_padded.launches_by["wgmma_bf16"] == n0 + 1,
              f"{name} did not run the wgmma path")
        errs["bf16 wgmma K_eff 64-3072"] = max(
            errs.get("bf16 wgmma K_eff 64-3072", 0.0), err)
    xi, yi = (torch.from_numpy(rng.integers(-100, 100, s)).to(torch.int8)
              .to(dev) for s in ((200, 300), (300, 100)))
    n0 = gemm.gemm_padded.launches_by["wgmma_s8"]
    errs["int8"], _ = gemm_case(xi, yi, TilePolicy(128, 128, 128), 0, 0,
                                "gemm 200x100x300 int8")
    check(gemm.gemm_padded.launches_by["wgmma_s8"] == n0 + 1,
          "gemm 200x100x300 int8 did not run the wgmma s8 path")
    for M, N, K in S8_GEMM_SHAPES:
        name = f"gemm {M}x{N}x{K} int8"
        xi, yi = (torch.from_numpy(rng.integers(-128, 128, s))
                  .to(torch.int8).to(dev) for s in ((M, K), (K, N)))
        n0 = gemm.gemm_padded.launches_by["wgmma_s8"]
        err, _ = gemm_case(xi, yi, TilePolicy(128, 128, 128), 0, 0, name)
        check(gemm.gemm_padded.launches_by["wgmma_s8"] == n0 + 1,
              f"{name} did not run the wgmma s8 path")
        errs["int8"] = max(errs["int8"], err)
    for M, N, K in F32_RAGGED_SHAPES:
        x, y = arr((M, K)), arr((K, N))
        n0 = gemm.gemm_padded.launches_by["simt"]
        out = gemm.gemm_padded(x, y, TilePolicy(1, 1, 1))
        check(gemm.gemm_padded.launches_by["simt"] == n0 + 1,
              f"f32 {M}x{N}x{K} did not run the SIMT path")
        errs["f32 unpadded"] = max(errs.get("f32 unpadded", 0.0), close(
            torch, f"gemm {M}x{N}x{K} f32 unpadded", out, ref_matmul(x, y),
            1e-3, 1e-4 * max(1.0, K / 128)))
    errs["cm=cn=2"], prof = gemm_case(
        arr((300, 200)), arr((200, 150)),
        TilePolicy(128, 128, 128, cm=2, cn=2), 1e-3, 1e-4,
        "gemm 300x150x200 f32 cm=cn=2")
    check(prof.profiled_flops == 2 * 512 * 256 * 256,
          f"cm=cn=2 profile {prof.profiled_flops}")
    print("gemm small shapes (5 shapes x f32/bf16, 3 bf16 K_eff of the "
          f"wgmma ring, {1 + len(S8_GEMM_SHAPES)} int8 of the s8 ring, "
          f"{len(F32_RAGGED_SHAPES)} unpadded f32, cm=cn=2): max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    errs = {}
    ragged = [(2, 128, 200, 8, 2, 32, True), (2, 100, 100, 8, 2, 32, True)]
    for B, Sq, Sk, H, KV, hd, causal in FLASH_SHAPES + ragged:
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
            q, k, v = (arr(s, dtype) for s in ((B, Sq, H, hd),
                                               (B, Sk, KV, hd),
                                               (B, Sk, KV, hd)))
            n0 = fa.flash_attention_kernel.launches
            out = ops.flash(q, k, v, causal=causal)
            check(fa.flash_attention_kernel.launches == n0 + 1,
                  f"flash {Sq}x{Sk} did not launch the kernel")
            key = f"{'ragged ' if Sk % 64 or Sq % 64 else ''}{dtype}"
            errs[key] = max(errs.get(key, 0.0), close(
                torch, f"flash {(B, Sq, Sk, H, KV, hd, causal)} {dtype}",
                out, ref_attention(q, k, v, causal=causal), tol, tol))
    n_tc = 0
    for B, Sq, Sk, H, KV, hd, causal in TC_FLASH_SHAPES:
        q, k, v = (arr(s, torch.bfloat16) for s in ((B, Sq, H, hd),
                                                    (B, Sk, KV, hd),
                                                    (B, Sk, KV, hd)))
        n0 = fa.flash_attention_kernel.launches_by["wgmma_bf16"]
        out = ops.flash(q, k, v, causal=causal)
        n_tc += fa.flash_attention_kernel.launches_by["wgmma_bf16"] - n0
        check(fa.flash_attention_kernel.launches_by["wgmma_bf16"] == n0 + 1,
              f"bf16 flash {(B, Sq, Sk, H, KV, hd, causal)} did not run the "
              "wgmma kernel")
        key = f"bf16 wgmma hd {hd}"
        errs[key] = max(errs.get(key, 0.0), close(
            torch, f"flash {(B, Sq, Sk, H, KV, hd, causal)} bf16", out,
            ref_attention(q, k, v, causal=causal), 5e-2, 5e-2))
    for B, Sq, Sk, H, KV, hd, causal in SIMT_WIDE_FLASH_SHAPES:
        q, k, v = (arr(s) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                    (B, Sk, KV, hd)))
        n0 = fa.flash_attention_kernel.launches_by["simt"]
        out = ops.flash(q, k, v, causal=causal)
        check(fa.flash_attention_kernel.launches_by["simt"] == n0 + 1,
              f"f32 flash {(B, Sq, Sk, H, KV, hd, causal)} did not run the "
              "SIMT kernel")
        errs[f"f32 SIMT hd {hd}"] = close(
            torch, f"flash {(B, Sq, Sk, H, KV, hd, causal)} f32", out,
            ref_attention(q, k, v, causal=causal), 1e-3, 1e-3)
    print(f"flash small shapes (4 shapes + Sk=200 + Sq=100, each "
          f"f32 and bf16; {n_tc} bf16 shapes of the wgmma kernel: hd 64, 96, "
          "112, 128 and 192, G 1/3/4, causal and full, Sk=200 and Sq=100; "
          f"{len(SIMT_WIDE_FLASH_SHAPES)} f32 SIMT shapes at hd 192 and 256; "
          "every call launched its kernel): max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    err = 0.0
    for BC, Q, nh, hd, ds, hb in SSD_SHAPES:
        x = arr((BC, Q, nh, hd), scale=0.5)
        dt = torch.from_numpy(rng.uniform(0.001, 0.1, (BC, Q, nh))) \
            .float().to(dev)
        A = -torch.from_numpy(rng.uniform(0.5, 2.0, (nh,))).float().to(dev)
        dacs = torch.cumsum(dt * A, dim=1)
        b, c = arr((BC, Q, nh, ds), scale=0.3), arr((BC, Q, nh, ds),
                                                    scale=0.3)
        err = max(err, close(torch, f"ssd_intra {(BC, Q, nh, hd, ds)}",
                             ssd_intra_kernel(x, dt, dacs, b, c,
                                              head_block=hb),
                             ref_ssd_intra(x, dt, dacs, b, c), 1e-3, 1e-3))
    n_tc, tc_err = 0, 0.0
    for BC, Q, nh, hd, g, ds in TC_SSD_SHAPES:
        x = arr((BC, Q, nh, hd), torch.bfloat16, 0.5)
        dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                                 (BC, Q, nh)))).float().to(dev)
        A = -torch.from_numpy(rng.uniform(1.0, 16.0, (nh,))).float().to(dev)
        dacs = torch.cumsum(dt * A, dim=1)
        b, c = (arr((BC, Q, g, ds), torch.bfloat16, 0.3) for _ in range(2))
        n0 = ssd_intra_kernel.launches_by["wgmma_bf16"]
        out = ssd_intra_kernel(x, dt, dacs, b, c)
        check(ssd_intra_kernel.launches_by["wgmma_bf16"] == n0 + 1,
              f"bf16 ssd_intra {(BC, Q, nh, hd, g, ds)} did not run the wgmma "
              "kernel")
        n_tc += 1
        tc_err = max(tc_err, close_rows(
            torch, f"ssd_intra {(BC, Q, nh, hd, g, ds)} bf16", out,
            ref_ssd_intra(x, dt, dacs, b, c),
            {"zeroed": torch.zeros_like(out)}))
    B, S, nh, hd, g, ds, Q = 2, 64, 4, 16, 2, 8, 16
    args = (arr((B, S, nh, hd), scale=0.5),
            torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, nh))).float()
            .to(dev),
            -torch.from_numpy(rng.uniform(0.5, 2.0, (nh,))).float().to(dev),
            arr((B, S, g, ds), scale=0.3), arr((B, S, g, ds), scale=0.3))
    path_err = close(torch, "ops.ssd small", ops.ssd(*args, chunk=Q),
                     ops.ssd(*(a.cpu() for a in args), chunk=Q).to(dev),
                     1e-3, 1e-3)
    print(f"ssd small shapes (3 intra-chunk shapes; {n_tc} bf16 shapes of "
          "the wgmma kernel: Q 64-320, hd 64/128, ds 64-256, g 1/2/nh, 1-2 "
          f"heads an item, each launched it; ops.ssd {B}x{S} against its "
          f"plain path on the CPU): max |diff| intra {err:.3e}, wgmma "
          f"{tc_err:.3e}, path {path_err:.3e}")


def kernel_api_paths(torch, dev, counters: dict) -> list:
    """Drives each kernel API path with every launch count set to 0 just
    before and read just after, fails if the path never launched its
    kernel, then runs the path's plain-version checks and timings;
    returns one kernel record a path."""
    records = []
    torch.cuda.reset_peak_memory_stats(dev)
    for name, path in (
            ("gemm", gemm_path), ("ssd_intra", ssd_path),
            ("ssd_intra", lambda t, d: ssd_path(t, d, "zamba2-7b")),
            ("ssd_intra", lambda t, d: ssd_path(t, d, "mamba2-780m",
                                                "float32")),
            ("ssd_intra", lambda t, d: ssd_path(t, d, "zamba2-7b",
                                                "float32")),
            ("flash_attention", flash_path)):
        for c in counters.values():
            c.launches = 0
            for v in getattr(c, "launches_by", {}):
                c.launches_by[v] = 0
        torch.cuda.synchronize()
        run = path(torch, dev)          # drives the path, returns a closure
        torch.cuda.synchronize()
        counts = {n: c.launches for n, c in counters.items()}
        by = dict(getattr(counters[name], "launches_by", {}))
        print(f"{name} path: launches {counts}" + (
            f"; {name} by variant {by}" if by else ""))
        check(counts[name] >= 1, f"the {name} path never launched its "
              "kernel")
        want = getattr(run, "launches_by", None)
        check(want is None or by == want, f"the {name} path launched its "
              f"variants {by}, expected {want}")
        rec = {"name": name, "route": "cuda", "launches": counts[name],
               **run()}
        if records and records[-1]["name"] == name:
            # another published width or working type of the same kernel:
            # under the first's record, by its model (" f32" for f32)
            records[-1].setdefault("paths", {})[run.key] = rec
        else:
            records.append(rec)
    print(f"peak device memory over the kernel API paths "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return records


def gemm_inputs(torch, gen, dev, M, N, K, kind):
    """Operands of one full-width GEMM, made on the card from `gen`."""
    if kind == "int8":
        return (torch.randint(-128, 128, s, generator=gen, device=dev,
                              dtype=torch.int8) for s in ((M, K), (K, N)))
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return (torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((M, K), (K, N)))


def gemm_path(torch, dev):
    """The GEMM path at full width: the characterization table, then
    `ops.matmul` with `pick_policy`'s choice on each model's two dominant
    GEMMs in bf16, fp32 and int8, and on whisper-small's two encoder
    GEMMs in bf16, which its 1,500 tokens leave unaligned.  This checks
    the Eq. 3 padding: the FLOPs of the padded grid each call hands the
    kernel (2·M_eff·N_eff·K_eff, counted by the wrapper from the shapes
    it launches; the kernel's loops run over exactly those shapes) must
    equal its GemmProfile's and the closed form's, and each model's bf16
    executed/theoretical ratio the tile factor: the fleet engine's
    `_tile_quant_factor` at 4,096 tokens (1 for the aligned models), the
    same mean at whisper's 1,500 (1.024).  Returns the
    closure that holds each call against the plain version and times it
    (tolerances: bf16 the JAX test's rtol 0.2/atol 2e-2; f32 rtol 1e-3
    with the test's atol 1e-4 grown linearly in K/128, as the worst-case
    rounding of an f32 sum grows; int8 exact)."""
    from repro_torch.configs import get_config
    from repro_torch.core.peaks import DEFAULT_CHIP
    from repro_torch.core.tile_quant import (pick_policy, profiled_flops,
                                             theoretical_flops)
    from repro_torch.examples import gemm_characterization
    from repro_torch.fleet.jobs import _tile_quant_factor
    from repro_torch.kernels import gemm, ops

    n0, f0 = gemm.gemm_padded.launches, gemm.gemm_padded.launched_flops
    profs = [p for _, p in gemm_characterization.main(device=dev)]
    check(gemm.gemm_padded.launches - n0 == len(profs)
          and gemm.gemm_padded.launched_flops - f0
          == sum(p.profiled_flops for p in profs)
          and all(p.profiled_flops == profiled_flops(p.M, p.N, p.K, p.policy)
                  for p in profs),
          "characterization: launched FLOPs differ from the profiles")
    print(f"characterization: {len(profs)} launches, padded grids of "
          f"{gemm.gemm_padded.launched_flops - f0:,d} FLOPs == sum of "
          "profiled == closed form")

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for model in GEMM_MODELS + ("whisper-small",):
        cfg = get_config(model)
        d = cfg.d_model
        # the fleet's tokens per GEMM; whisper's encoder takes 1,500 frames
        tokens = cfg.encoder_seq if model == "whisper-small" else 4096
        kinds = ("bf16",) if model == "whisper-small" else ("bf16", "fp32",
                                                             "int8")
        bf16 = []
        for M, N, K in [(tokens, d, d), (tokens, cfg.d_ff or d, d)]:
            for kind in kinds:
                x, y = gemm_inputs(torch, gen, dev, M, N, K, kind)
                f0 = gemm.gemm_padded.launched_flops
                out, prof = ops.matmul(x, y)
                launched = gemm.gemm_padded.launched_flops - f0
                closed = profiled_flops(M, N, K, pick_policy(M, N, K, kind))
                check(launched == prof.profiled_flops == closed,
                      f"{model} ({M}, {N}, {K}) {kind}: launched "
                      f"{launched}, profiled {prof.profiled_flops}, closed "
                      f"form {closed}")
                print(f"gemm {model} ({M}, {N}, {K}) {kind}: policy "
                      f"{prof.policy.name}, padded grid {launched:,d} "
                      "FLOPs == profiled == closed form")
                cases.append((model, (M, N, K), kind, x, y, out, prof))
                if kind == "bf16":
                    bf16.append(prof)
        ratio = float(np.mean([p.profiled_flops / p.theoretical_flops
                               for p in bf16]))
        if tokens == 4096:
            factor, of = _tile_quant_factor(cfg, DEFAULT_CHIP), \
                "_tile_quant_factor"
        else:        # its closed form, at the encoder's token count
            factor = float(np.mean([
                profiled_flops(p.M, p.N, p.K, pick_policy(p.M, p.N, p.K))
                / theoretical_flops(p.M, p.N, p.K) for p in bf16]))
            of = f"the tile factor at {tokens} tokens"
            check(factor > 1, f"{model}: the tile factor is {factor!r}")
        check(ratio == factor, f"{model}: bf16 executed/theoretical "
              f"{ratio!r} != {of} {factor!r}")
        print(f"gemm {model}: bf16 executed/theoretical {ratio!r} == "
              f"{of} {factor!r}")
    n_bf16 = sum(c[2] == "bf16" for c in cases)

    def run() -> dict:
        from repro_torch.kernels.ref import ref_matmul
        library = {"bf16": torch.matmul, "fp32": torch.matmul,
                   "int8": torch._int_mm}
        record, paths = None, {}
        while cases:
            model, (M, N, K), kind, x, y, out, prof = cases.pop(0)
            tol = {"int8": (0, 0), "fp32": (1e-3, 1e-4 * K / 128),
                   "bf16": (0.2, 2e-2)}[kind]
            err = close(torch, f"gemm {model} ({M}, {N}, {K}) {kind}", out,
                        ref_matmul(x, y), *tol)
            pol = prof.policy
            xp = ops._pad_to(x, pol.tm * pol.cm, pol.tk).contiguous()
            yp = ops._pad_to(y, pol.tk, pol.tn * pol.cn).contiguous()
            ms = event_ms(torch, lambda: gemm._launch(xp, yp), REPS)
            plain_ms = event_ms(torch, lambda: ref_matmul(x, y), REPS)
            lib_ms = event_ms(torch, lambda: library[kind](x, y), REPS)
            (Me, Ke), Ne = xp.shape, yp.shape[1]
            b = bound((Me * Ke + Ke * Ne) * x.element_size()
                      + Me * Ne * out.element_size(), 2 * Me * Ne * Ke, kind)
            print(f"gemm {model} ({M}, {N}, {K}) {kind} "
                  f"[{gemm.variant(x.dtype)}]: max |diff| {err:.3e}; kernel "
                  f"{ms:.4f} ms ({2 * Me * Ne * Ke / ms / 1e9:.1f} TFLOP/s, "
                  f"{b['bound_ms'] / ms:.1%} of bound, {ms / lib_ms:.2f}x "
                  f"the library), plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})" + (
                      f"; former wmma kernel "
                      f"{WMMA_GEMM_BF16_MS[model, (M, N, K)]:.4f} ms"
                      if kind == "bf16" else
                      f"; former SIMT kernel "
                      f"{OLD_SIMT_GEMM_MS[model, (M, N, K), kind]:.4f} ms"
                      if (model, (M, N, K), kind) in OLD_SIMT_GEMM_MS
                      else ""))
            if (model, (M, N, K)) == RECORD_GEMM[:2] and kind != "bf16":
                paths[kind] = {"variant": gemm.variant(x.dtype),
                               "max_abs_err": err, "ms": ms,
                               "library_ms": lib_ms, **b}
                n = max(1, int(1000 / ms))         # ~1 s of queued work
                kern = clocks_under(torch, lambda: gemm._launch(xp, yp), n)
                lib = clocks_under(torch, lambda: library[kind](x, y), n)
                print(f"  SM clock MHz, power W under load: kernel {kern}; "
                      f"library {lib}")
            if kind == "int8":
                t_ms = transpose_ms(torch, yp)
                print(f"  of which the transpose of B ({Ke}, {Ne}) to Bt "
                      f"alone: {t_ms:.4f} ms, bound "
                      f"{2 * Ke * Ne / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
            if (model, (M, N, K), kind) == RECORD_GEMM:
                record = {"source": "src/repro_torch/kernels/csrc/gemm.cu",
                          "replaces": "src/repro/kernels/gemm.py:24",
                          "variant": gemm.variant(x.dtype),
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          **b, "library_ms": lib_ms}
        check(record is not None and set(paths) == {"fp32", "int8"},
              f"the path ran no {RECORD_GEMM[:2]} GEMM of each type")
        # the same FFN GEMM in the other working types, on their paths
        return {**record, "paths": paths}
    # every bf16 model and whisper GEMM takes the bf16 wgmma path, every
    # int8 one the s8 path, the characterization's f32 GEMMs and the
    # fp32 ones the SIMT path
    n_int8 = sum(c[2] == "int8" for c in cases)
    run.launches_by = {"wgmma_bf16": n_bf16, "wgmma_s8": n_int8,
                       "simt": len(profs) + len(cases) - n_bf16 - n_int8}
    return run


def clocks_under(torch, fn, reps: int) -> str:
    """The SM clock and power draw that nvidia-smi reads while reps calls
    of fn are queued on the card (a card under its power limit slows
    down under load)."""
    torch.cuda.synchronize()
    for _ in range(reps):
        fn()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not measured"


def transpose_ms(torch, y) -> float:
    """Device time of the int8 path's pre-pass alone (Bt = yᵀ by the
    hand-written transpose of csrc/gemm.cu), checked against yᵀ."""
    import ctypes

    from repro_torch.kernels import _build
    fn = _build.load("gemm").gemm_transpose_s8
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [p, p, i32, i32, i32, p], i32
    K, N = y.shape
    bt = torch.empty((N, K), dtype=torch.int8, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream

    def launch():
        rc = fn(y.data_ptr(), bt.data_ptr(), K, N, y.device.index, stream)
        check(rc == 0, f"transpose launch failed: CUDA error {rc}")
    launch()
    check(torch.equal(bt, y.t()), f"the transpose of ({K}, {N}) is wrong")
    return event_ms(torch, launch, REPS)


def ssd_path(torch, dev, model: str = "mamba2-780m", dtype_name=None):
    """The SSD path at a published width: `ops.ssd` on B = 1, S = 4,096
    with the config's heads, head dim, groups, state and chunk (mamba2-780m:
    16 chunks of 256, 48 heads of 64, one group of state 128; zamba2-7b:
    112 heads of 64, two groups of state 64), x/B/C in the config's bf16
    (the tensor-core kernel) or, given "float32", in f32 (the SIMT kernel),
    dt log-uniform in [1e-3, 1e-1] and A = -U(1, 16) (Mamba2's
    initialisation ranges).  The closure holds the output against the
    same entry point on CPU copies (its plain path) and the kernel against
    its plain version on the path's inputs, with `close_rows` (mutants:
    zeroed, each chunk's last diagonal tile dropped (128 columns on the
    tensor-core kernel, 64 on the SIMT one), and the decays of the next
    head of the kernel's head block), then times the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.kernels.ref import ref_ssd_intra
    cfg = get_config(model)
    B, S = 1, 4096
    nh, hd, g, ds = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                     cfg.ssm_state)
    dtype = getattr(torch, dtype_name or cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn((B, S, nh, hd), generator=gen, device=dev) * 0.5) \
        .to(dtype)
    dt = torch.empty((B, S, nh), device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen).exp_()
    A = -torch.empty(nh, device=dev).uniform_(1.0, 16.0, generator=gen)
    Bm, Cm = ((torch.randn((B, S, g, ds), generator=gen, device=dev) * 0.3)
              .to(dtype) for _ in range(2))
    t0 = time.perf_counter()
    y = ops.ssd(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    torch.cuda.synchronize()
    print(f"ssd path: ops.ssd {cfg.name} ({B}, {S}, {nh}, {hd}), g {g}, ds "
          f"{ds}, chunk {cfg.ssm_chunk}, {dtype}: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")
    short = "bf16" if dtype == torch.bfloat16 else "f32"

    def run() -> dict:
        y_plain = ops.ssd(*(t.cpu() for t in (x, dt, A, Bm, Cm)),
                          chunk=cfg.ssm_chunk)
        path_err = close_rows(torch, f"ops.ssd at {cfg.name} width, {short}",
                              y, y_plain.to(dev),
                              {"zeroed": torch.zeros_like(y)})
        del y_plain
        inputs = ops.ssd_intra_inputs(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        BC, Q = inputs[0].shape[:2]
        path = ssd_scan.variant(dtype, Q, hd, ds)
        hb = ssd_scan.wgmma_heads(hd, nh, g) if path == "wgmma_bf16" \
            else ssd_scan.simt_heads(hd)
        tile = 128 if path == "wgmma_bf16" else ssd_scan._SIMT_ROWS
        got = ssd_scan._launch(*inputs)
        want = ref_ssd_intra(*inputs)
        # a kernel that skips each chunk's last diagonal tile: its last
        # rows lose what their own columns give them
        tail = ref_ssd_intra(*(t[:, -tile:] for t in inputs))
        dropped = want.clone()
        dropped[:, -tile:] = (want[:, -tile:].float() - tail.float()) \
            .to(dtype)
        # a kernel that shares C.B^T over its head block but takes each
        # head's decays from the next head of the block
        nxt = torch.arange(nh, device=dev)
        nxt = nxt - nxt % hb + (nxt % hb + 1) % hb if hb > 1 else \
            (nxt + 1) % nh
        x_, dt_, dacs_, b_, c_ = inputs
        wrong = ref_ssd_intra(x_, dt_[..., nxt].contiguous(),
                              dacs_[..., nxt].contiguous(), b_, c_)
        err = close_rows(torch, f"ssd_intra at {cfg.name} width, {short}",
                         got, want,
                         {"zeroed": torch.zeros_like(want),
                          "diagonal-tile-dropped": dropped,
                          "wrong-head": wrong})
        del want, tail, dropped, wrong
        ms = event_ms(torch, ssd_launcher(torch, ssd_scan, inputs),
                      SHORT_REPS)
        plain_ms = event_ms(torch, lambda: ref_ssd_intra(*inputs), REPS)
        n_bytes = sum(t.numel() * t.element_size() for t in inputs) \
            + got.numel() * got.element_size()
        pairs = BC * Q * (Q + 1) // 2
        # C.B and M.X over the causal pairs, and M's decay and scale, a
        # head (the TPU kernel's count, PERF.md's convention); a kernel
        # that shares C.B^T needs it only once a (chunk, group)
        per_head = pairs * nh * (2 * ds + 2 * hd + 4)
        shared = pairs * (g * 2 * ds + nh * (2 * hd + 4))
        # the wgmma kernel is held to the per-head count, as before; the
        # SIMT kernel, which shares C.B^T too, to the shared one
        n_ops = per_head if path == "wgmma_bf16" else shared
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        b = bound(n_bytes, n_ops, kind)
        former = SIMT_SSD_MS.get((model, short))
        print(f"ssd_intra {cfg.name} ({BC}, {Q}, {nh}, {hd}, g {g}, ds {ds}) "
              f"{short} [{path}, {hb} heads an item]: max |diff| kernel "
              f"{err:.3e}, path {path_err:.3e}; kernel {ms:.4f} ms "
              f"({n_ops / ms / 1e9:.1f} TFLOP/s as the bound counts, "
              f"{b['bound_ms'] / ms:.1%} of bound"
              + (f"; former SIMT kernel {former:.4f} ms, {former / ms:.1f}x "
                 "slower" if former else "")
              + f"), plain {plain_ms:.4f} ms, library none, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}, "
              f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP; C.B^T a "
              f"head: {per_head / 1e9:.3f} GFLOP, "
              f"{bound(n_bytes, per_head, kind)['bound_ms']:.4f} ms; C.B^T "
              f"once a group: {shared / 1e9:.3f} GFLOP, "
              f"{bound(n_bytes, shared, kind)['bound_ms']:.4f} ms)")
        return {"source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                "replaces": "src/repro/kernels/ssd_scan.py:23",
                "variant": path, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, **b, "library_ms": None}
    # the one intra-chunk call of the path takes the tensor-core kernel in
    # bf16 and the SIMT kernel in f32
    run.launches_by = {"wgmma_bf16": int(short == "bf16"),
                       "simt": int(short == "f32")}
    run.key = cfg.name + ("" if short == "bf16" else " f32")
    return run


def ssd_launcher(torch, ssd_scan, inputs):
    """One launch of the SSD kernel the inputs take (`variant`) into a
    fixed output, with the C call's arguments made once, so that CUDA
    events time the card and not the wrapper's Python (~0.04 ms a call,
    near the tensor-core kernel's time)."""
    y = torch.empty_like(inputs[0])
    fn, args, scratch = ssd_scan._kernel_call(*inputs, y)

    def launch():
        rc = fn(*args)
        check(rc == 0, f"ssd_intra launch failed: CUDA error {rc}")
    launch.scratch = scratch            # lives as long as the launcher
    return launch


#: the flash path's calls, (model, working type): the head of B3's record
#: first, then its "paths" (keyed by model, " f32" for the f32 call)
FLASH_CALLS = (("llama3.2-3b", "bfloat16"), ("phi-3-vision-4.2b", "bfloat16"),
               ("zamba2-7b", "bfloat16"), ("nemotron-4-340b", "bfloat16"),
               ("phi-3-vision-4.2b", "float32"), ("zamba2-7b", "float32"),
               ("zamba2-7b-instruct", "bfloat16"))


def flash_path(torch, dev):
    """The flash path at published widths: `ops.flash` on B = 1,
    S = 4,096, causal, in bf16 at llama3.2-3b (24 query heads over 8 kv
    heads of 128), phi-3-vision-4.2b (32 heads of 96), zamba2-7b's
    shared attention (32 heads of 112) and nemotron-4-340b (96 over 8
    heads of 192), all on the tensor-core kernel, in f32 at
    phi-3-vision-4.2b and zamba2-7b width on the SIMT kernel, and in bf16
    at zamba2-7b-instruct's shared blocks as its train cell runs them
    (B = 2, 32 heads of 224, scale (224 / 2)^-1/2) on the SIMT kernel,
    which serves bf16 at head dims the tensor-core kernel lacks.  The
    closure holds each against the plain version with `close_rows` and
    times kernel, plain version and `scaled_dot_product_attention`."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    calls = []
    for seed, (model, dtype_name) in enumerate(FLASH_CALLS, start=2):
        cfg = get_config(model)
        # the zamba2 family's blocks read concat(x, e) and scale by
        # (hd / 2)^-1/2; its train cell runs two sequences a step
        zamba2 = cfg.family == "zamba2"
        B, S, H, KV, hd = (2 if zamba2 else 1, 4096, cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim)
        scale = (hd / 2 if zamba2 else hd) ** -0.5
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        t0 = time.perf_counter()
        out = ops.flash(q, k, v, causal=True, scale=scale)
        torch.cuda.synchronize()
        print(f"flash path: ops.flash {cfg.name} ({B}, {S}, H {H}, KV {KV}, "
              f"hd {hd}, scale {scale:.6f}), causal, {dtype}: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")
        calls.append((cfg, q, k, v, out, scale))

    def run() -> dict:
        head, *rest = (flash_record(torch, *call) for call in calls)
        return {**head, "paths": {
            cfg.name + ("" if q.dtype == torch.bfloat16 else " f32"): rec
            for (cfg, q, *_), rec in zip(calls[1:], rest)}}
    # the bf16 calls at the tensor-core head dims take the tensor-core
    # kernel; the f32 ones and bf16 at hd 224 the SIMT
    run.launches_by = {"wgmma_bf16": 4, "simt": 3}
    return run


def flash_record(torch, cfg, q, k, v, out, scale) -> dict:
    """One full-width causal flash call at its softmax scale against its
    plain version with
    `close_rows` (mutants: zeroed, the last rows' diagonal key tile
    dropped (32 keys on the tensor-core kernel, the SIMT kernel's own
    64-key tile there) and, past hd 64, q and k zeroed past column 64: a
    kernel that drops the second box), and f32 also within the JAX tests'
    1e-3; timed beside the plain version, SDPA (the CUDA kernel it ran
    named from `torch.profiler`) and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_attention
    B, S, H, hd = q.shape
    path = fa.variant(q.dtype, hd)
    want = ref_attention(q, k, v, causal=True, scale=scale)
    # a kernel that drops the last rows' diagonal key tile: they see only
    # the keys before it
    kt = fa._SIMT_KEYS if path == "simt" else 32
    dropped = want.clone()
    dropped[:, -kt:] = ref_attention(q[:, -kt:], k[:, :-kt], v[:, :-kt],
                                     causal=False, scale=scale)
    mutants = {"zeroed": torch.zeros_like(want),
               "diagonal-tile-dropped": dropped}
    if hd > 64:
        q64, k64 = q.clone(), k.clone()
        q64[..., 64:] = 0
        k64[..., 64:] = 0
        mutants["second-box-dropped"] = ref_attention(q64, k64, v,
                                                      causal=True,
                                                      scale=scale)
        del q64, k64
    err = close_rows(torch, f"flash at {cfg.name} width, {q.dtype}", out,
                     want, mutants)
    if q.dtype == torch.float32:
        close(torch, f"flash at {cfg.name} width, f32", out, want, 1e-3,
              1e-3)
    del want, dropped, mutants
    torch.cuda.empty_cache()             # nemotron's scores: 6.4 GB a copy
    ms = event_ms(torch, lambda: fa._launch(q, k, v, True, scale), REPS)
    plain_ms = event_ms(torch, lambda: ref_attention(q, k, v, causal=True,
                                                     scale=scale), REPS)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale, enable_gqa=True)
    lib_ms = event_ms(torch, sdpa, REPS)
    lib_kernel = sdpa_kernel(torch, sdpa)
    del qt, kt, vt
    n_ops = 4 * B * H * hd * (S * (S + 1) // 2)
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b = bound(n_bytes, n_ops, "bf16" if q.dtype == torch.bfloat16
              else "fp32")
    former = SIMT_FLASH_MS.get(
        (cfg.name, "bf16" if q.dtype == torch.bfloat16 else "f32"))
    print(f"flash {cfg.name} {q.dtype} [{path}]: max |diff| "
          f"{err:.3e}; kernel {ms:.4f} ms ({n_ops / ms / 1e9:.1f} "
          f"TFLOP/s, {b['bound_ms'] / ms:.1%} of bound, "
          f"{ms / lib_ms:.2f}x SDPA"
          + (f"; former SIMT kernel {former:.4f} ms, {former / ms:.1f}x "
             "slower" if former else "")
          + f"), plain {plain_ms:.4f} ms, library (SDPA: {lib_kernel}) "
          f"{lib_ms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
          f"{n_ops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB)")
    return {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:20",
            "variant": path, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **b, "library_ms": lib_ms,
            "library_kernel": lib_kernel}


def sdpa_kernel(torch, fn) -> str:
    """The CUDA kernel that took most device time over two calls of fn
    (`scaled_dot_product_attention`), by `torch.profiler`, in at most two
    tries; "not measured" where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        kernels, _ = device_times(prof.key_averages())
        if kernels:
            return kernels[0][2]
    return "not measured"


#: phase 10b's rows: (model, B, S), causal, at the model's head widths
FLASH_BWD_ROWS = (("granite-3-2b", 8, 4096), ("llama3.2-3b", 1, 4096))


def flash_bwd_phase(torch, dev, card: str) -> dict:
    """Phase 10b: B3's backward kernels at each of `FLASH_BWD_ROWS`,
    through `grad.flash_bwd` (the route the train step takes), held
    against `flash_bwd_plain` in f32 on the same bf16 inputs with
    `close_summands` (mutants: a zeroed gradient; for dq, what autograd
    gives under `grad_mutants`' dq-zeroed and the kernels' dq 2^-3 too
    large; for dk, the kernels' dk with one 64-key tile dropped),
    bitwise equal over two calls, timed beside the bound, the plain
    version and SDPA's backward."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grad, ops, ref
    out = {}
    for seed, (model, B, S) in enumerate(FLASH_BWD_ROWS, start=21):
        cfg = get_config(model)
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(s, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        do = torch.randn((B, S, H, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
        scale = hd ** -0.5
        with torch.no_grad():
            o = ops.flash(q, k, v, causal=True)
        routes = grad.flash_bwd_routes()
        launches = dict(fa.flash_attention_bwd_kernel.launches_by)
        got = grad.flash_bwd(q, k, v, o, do, causal=True, scale=scale)
        again = grad.flash_bwd(q, k, v, o, do, causal=True, scale=scale)
        torch.cuda.synchronize()
        now = grad.flash_bwd_routes()
        calls = {r: now[r] - routes[r] for r in now}
        check(calls == {"kernel": 2, "plain": 0},
              f"flash backward at {model} width took the routes {calls}, "
              f"not the kernels twice")
        now = fa.flash_attention_bwd_kernel.launches_by
        launched = {n: now[n] - launches[n] for n in now}
        check(launched == {"lse_d": 2, "dkdv": 2, "dq": 2},
              f"flash backward at {model} width launched {launched}, not "
              f"each kernel twice")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash backward at {model} width: two calls differ")
        del again
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with grad_mutants(torch)["dq-zeroed"]:
            ops.flash(*leaves, causal=True).backward(do)
        mutant_dq = leaves[0].grad
        del leaves
        f32 = [t.float() for t in (q, k, v, o, do)]
        plain = grad.flash_bwd_plain(*f32, causal=True, scale=scale)
        sigmas = ref.flash_bwd_scales(*f32, causal=True, scale=scale)
        del f32
        tile_dropped = got[1].clone()
        tile_dropped[:, S // 2:S // 2 + 64] = 0
        extra = {"dq": {"grad_mutants dq-zeroed": mutant_dq,
                        "2^-3 too large": got[0] * (1 + 2 ** -3)},
                 "dk": {"one 64-key tile dropped": tile_dropped}}
        err, rel = {}, {}
        for name, g, w, sg in zip(("dq", "dk", "dv"), got, plain, sigmas):
            mutants = {"zeroed": torch.zeros_like(w), **extra.get(name, {})}
            err[name], rel[name] = close_summands(
                torch, f"flash backward {name} at {model} width", g, w, sg,
                mutants)
        del got, plain, sigmas, mutant_dq, tile_dropped, extra
        torch.cuda.empty_cache()
        ms = event_ms(torch, lambda: fa.flash_attention_bwd_kernel(
            q, k, v, o, do, causal=True, scale=scale), REPS)
        plain_ms = event_ms(torch, lambda: grad.flash_bwd_plain(
            q, k, v, o, do, causal=True, scale=scale), 1)
        torch.cuda.empty_cache()
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = event_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), REPS)
        del qt, kt, vt, ot, dot
        # five products, 2·hd a causal pair each; q, o, dO, k, v read once
        # and dq, dk, dv written once
        n_ops = 10 * B * H * hd * (S * (S + 1) // 2)
        n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
        b = bound(n_bytes, n_ops, "bf16")
        print(f"flash backward {model} (B {B}, S {S}, H {H}, KV {KV}, hd "
              f"{hd}), causal, bf16 [kernel]: max |diff| dq {err['dq']:.3e}"
              f" dk {err['dk']:.3e} dv {err['dv']:.3e}; kernels {ms:.4f} ms "
              f"({b['bound_ms'] / ms:.1%} of bound, {ms / lib_ms:.2f}x "
              f"SDPA's backward), plain {plain_ms:.4f} ms, library (SDPA "
              f"backward) {lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}, {n_ops / 1e9:.1f} GFLOP, "
              f"{n_bytes / 1e6:.1f} MB); {card}")
        out[model] = {"source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
                      "route": "kernel", "max_abs_err": err, "rel_rms": rel,
                      "ms": ms, "plain_ms": plain_ms, **b,
                      "library_ms": lib_ms}
        del q, k, v, o, do
        torch.cuda.empty_cache()
    return out


#: phase 10c's layer: the model, and its train cell's batch and length
SSD_BWD_LAYER = ("zamba2-7b-instruct", 2, 4096)


def rounded_dm_plain(torch, *ins):
    """`grad.ssd_intra_bwd_plain` with dM = dY·Xᵀ rounded to bf16 where
    it forms it (torch.einsum patched for that product alone), so d dt
    and d dacs sum rounded values: the fault `F32_SUM_TOL` must reject."""
    from unittest import mock

    from repro_torch.kernels import grad
    einsum = torch.einsum

    def rounded(spec, *ops):
        out = einsum(spec, *ops)
        return out.bfloat16().to(out.dtype) \
            if spec == "zighp,zjghp->zghij" else out
    with mock.patch.object(torch, "einsum", rounded):
        return grad.ssd_intra_bwd_plain(*ins)


def ssd_bwd_phase(torch, dev, card: str) -> dict:
    """Phase 10c: the SSD backward's kernels at zamba2-7b-instruct's
    Mamba2 layer in its train cell (BC 32 chunks of Q 256, 112 heads of
    64, g 2, ds 64), through `grad.ssd_intra_bwd` (the route the train
    step takes), held against `ssd_intra_bwd_plain` in f32 on the same
    bf16 inputs with `close_summands` (σ from `ref.ssd_bwd_scales`; d dt
    and d dacs by `F32_SUM_TOL`, the others by `BWD_TOL`; mutants: a
    zeroed gradient, what the router gives under `grad_mutants`'
    d-dacs-dropped and next-head-decays, the kernels' dB without one
    64-column tile's contribution, and d dt and d dacs summed from dM
    rounded to bf16), bitwise equal over two calls, timed beside the
    bound, the plain version and B4's forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import grad, ref, ssd_scan
    model, B, S = SSD_BWD_LAYER
    cfg = get_config(model)
    Q, hd, g, ds = cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_ngroups, \
        cfg.ssm_state
    nh = cfg.ssm_expand * cfg.d_model // hd
    BC = B * S // Q
    check((BC, Q, nh, hd, g, ds) == (32, 256, 112, 64, 2, 64),
          f"{model}'s SSD layer is not (32, 256, 112, 64, 2, 64)")
    gen = torch.Generator(device=dev).manual_seed(31)
    x, dy = (torch.randn((BC, Q, nh, hd), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    b, c = ((torch.randn((BC, Q, g, ds), generator=gen, device=dev)
             * ds ** -0.5).to(torch.bfloat16) for _ in range(2))
    dt = torch.rand((BC, Q, nh), generator=gen, device=dev) * 0.1
    A = -torch.rand(nh, generator=gen, device=dev) * 4
    ins = (x, dt, torch.cumsum(dt * A, 1), b, c, dy)
    routes = grad.ssd_bwd_routes()
    launches = dict(ssd_scan.ssd_intra_bwd_kernel.launches_by)
    got = grad.ssd_intra_bwd(*ins)
    again = grad.ssd_intra_bwd(*ins)
    torch.cuda.synchronize()
    now = grad.ssd_bwd_routes()
    calls = {r: now[r] - routes[r] for r in now}
    check(calls == {"kernel": 2, "plain": 0},
          f"SSD backward at {model} width took the routes {calls}, not the "
          f"kernels twice")
    now = ssd_scan.ssd_intra_bwd_kernel.launches_by
    launched = {n: now[n] - launches[n] for n in now}
    check(launched == {"dg": 2, "dx": 2, "dbdc": 2},
          f"SSD backward at {model} width launched {launched}, not each "
          f"kernel twice")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"SSD backward at {model} width: two calls differ")
    del again
    mutant = {}
    for name in ("d-dacs-dropped", "next-head-decays"):
        with grad_mutants(torch)[name]:
            mutant[name] = grad.ssd_intra_bwd(*ins)
    # the kernels' dB without the contribution of dG's tile (rows 192-255,
    # columns 64-127) of chunk 0, group 0, from the kernels' own f32 dG
    dg = ssd_scan.ssd_intra_bwd_op(*ins)[-1]
    tile_dropped = got[3].float()
    tile_dropped[0, 64:128, 0] -= dg[0, 0, 192:256, 64:128].T \
        @ c[0, 192:256, 0].float()
    del dg
    f32 = [t.float() for t in ins]
    plain = grad.ssd_intra_bwd_plain(*f32)
    rounded = rounded_dm_plain(torch, *f32)[1:3]
    sigmas = ref.ssd_bwd_scales(*f32)
    del f32
    err, rel = {}, {}
    names = ("dx", "ddt", "ddacs", "db", "dc")
    for k, (name, gt, w, sg) in enumerate(zip(names, got, plain, sigmas)):
        mutants = {"zeroed": torch.zeros_like(w),
                   "next-head-decays": mutant["next-head-decays"][k]}
        tol = BWD_TOL
        if name in ("ddt", "ddacs"):
            mutants["summed from dM rounded to bf16"] = rounded[k - 1]
            tol = F32_SUM_TOL
        if name == "ddacs":
            mutants["grad_mutants d-dacs-dropped"] = mutant[
                "d-dacs-dropped"][k]
        if name == "db":
            mutants["one 64-column tile's contribution dropped"] = \
                tile_dropped
        err[name], rel[name] = close_summands(
            torch, f"SSD backward {name} at {model} width", gt, w, sg,
            mutants, tol)
    del got, plain, sigmas, mutant, tile_dropped, rounded
    torch.cuda.empty_cache()
    ms = event_ms(torch, lambda: ssd_scan.ssd_intra_bwd_kernel(*ins), REPS)
    plain_ms = event_ms(torch, lambda: grad.ssd_intra_bwd_plain(*ins), 1)
    fwd_ms = event_ms(torch, lambda: ssd_scan.ssd_intra_kernel(*ins[:5]),
                      REPS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ssd_scan.ssd_intra_bwd_kernel(*ins)
        torch.cuda.synchronize()
    kernels, _ = device_times(prof.key_averages())
    # the products the gradients need over the causal pairs: C·Bᵀ, dC and
    # dB a group, dM and dX a head; x, dy, dx, b, c, db, dc, dt, dacs, d
    # dt and d dacs read or written once
    pairs = BC * Q * (Q + 1) // 2
    n_ops = pairs * (g * 3 * 2 * ds + nh * 2 * 2 * hd)
    n_bytes = 3 * x.numel() * 2 + 4 * b.numel() * 2 + 4 * dt.numel() * 4
    bd = bound(n_bytes, n_ops, "bf16")
    print(f"SSD backward {model} (BC {BC}, Q {Q}, nh {nh}, hd {hd}, g {g}, "
          f"ds {ds}), bf16 [kernel]: max |diff| "
          + " ".join(f"{n} {err[n]:.3e}" for n in names)
          + f"; kernels {ms:.4f} ms ({bd['bound_ms'] / ms:.1%} of bound; "
          f"{top_times(kernels, 3) if kernels else 'split not measured'}), "
          f"plain {plain_ms:.4f} ms, B4's forward "
          f"{fwd_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']},"
          f" {n_ops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB); {card}")
    out = {model: {"source": "src/repro_torch/kernels/csrc/ssd_bwd.cu",
                   "route": "kernel", "max_abs_err": err, "rel_rms": rel,
                   "ms": ms, "plain_ms": plain_ms, "forward_ms": fwd_ms,
                   **bd}}
    del x, dy, b, c, dt, A, ins
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 11. the model zoo's serving path at full width
# ---------------------------------------------------------------------------
#: the full-width model: its prefill runs both model kernels on their
#: tensor-core variants (flash hd 112, SSD hd 64 / ds 64), and its 13.6 GB
#: of bf16 parameters fit one card whole
SERVE_MODEL = "zamba2-7b"
PREFILL_S, DECODE_B, DECODE_CTX, DECODE_TOKENS = 4096, 4, 4096, 32
#: one layer group's card-vs-CPU check (the shared block and layers 0-5)
#: and the decode-vs-forward check's tokens
GROUP_S, DECODE_CHECK_T = 512, 64
#: a bf16 model output on the card may lie this many times as far from
#: the f32 result as the CPU's plain bf16 route does (`bf16_close`)
BF16_MODEL_FACTOR = 1.25
#: decode against forward at full depth: max |logit diff| over the
#: forward's logit RMS, in bf16 and in f32 (the witness that the bf16 gap
#: is rounding).  NVIDIA H100 80GB HBM3, 700 W, this script: bf16 read
#: 0.5624 and 0.5809, f32 8.67e-5, the mutants 2.39 and up in both; each
#: bf16 limit is ~1.3x its larger reading, the f32 one ~10x its reading
DECODE_VS_FORWARD_LIMIT = 0.75
DECODE_VS_FORWARD_F32_LIMIT = 1e-3
#: the other families at published width, 2 layers: (model, prefill S)
FAMILY_MODELS = (("llama3.2-3b", 64), ("mamba2-780m", 256),
                 ("whisper-small", 64))


def zero_counts(*kernels) -> None:
    for k in kernels:
        k.launches = 0
        for v in k.launches_by:
            k.launches_by[v] = 0


def model_mutants(torch, hb: int):
    """Wrong model outputs the checks must reject, each a patch of the
    kernel API that a model reaches: attention output zeroed, the SSD
    without its diagonal (intra-chunk) term, and the SSD with each
    head's decays taken from the next head of the kernel's head block."""
    from unittest import mock

    from repro_torch.kernels import ops, ssd_scan

    def next_head(x, dt, dacs, b, c):
        nh = dt.shape[-1]
        nxt = torch.arange(nh, device=dt.device)
        nxt = nxt - nxt % hb + (nxt % hb + 1) % hb if hb > 1 else \
            (nxt + 1) % nh
        return ssd_scan._launch(x, dt[..., nxt].contiguous(),
                                dacs[..., nxt].contiguous(), b, c)
    return {
        "attention-zeroed": mock.patch.object(
            ops, "flash", lambda q, k, v, **kw: torch.zeros_like(q)),
        "ssd-diagonal-dropped": mock.patch.object(
            ssd_scan, "ssd_intra_kernel",
            lambda x, *a, **kw: torch.zeros_like(x)),
        "next-head-decays": mock.patch.object(ssd_scan, "ssd_intra_kernel",
                                              next_head),
    }


def model_phase(torch, dev, card: str, kernel_ms: dict) -> dict:
    """Phase 11: zamba2-7b at full width through the port's serving entry
    points, and three other families at published width.  Returns each
    model kernel's launches in the full-width prefill forward, the
    full-width parameters (phase 12 trains them), and the prefill's mean
    ms, the decode loop's ms a token, and the peak device memory of the
    prefill and of the decode loop, each after a reset (phase 14 holds
    the dry run to them).

    `kernel_ms` holds phase 10's times of the flash and SSD kernels at
    zamba2-7b's width, from which the prefill's share in them is worked
    out beside the profiler's own reading."""
    from repro_torch.configs import ShapeSpec, get_config, make_inputs
    from repro_torch.flops.accounting import param_count_analytic, step_flops
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel, wgmma_heads
    from repro_torch.launch.serve import decode_batch, generate
    from repro_torch.models import init_params, param_count
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.steps import make_prefill_step
    t_phase = time.perf_counter()
    fa, sk = flash_attention_kernel, ssd_intra_kernel
    cfg = get_config(SERVE_MODEL)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    with torch.no_grad():   # plain tensors: phase 12 trains them in place
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        n_params = param_count(params)
        param_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(params))
        print(f"model: {cfg.name} on the card, {n_params:,d} parameters "
              f"({param_bytes / 1e9:.2f} GB; param_count_analytic "
              f"{param_count_analytic(cfg):,.0f}), initialised from a "
              f"seeded generator in {time.perf_counter() - t0:.2f} s")
        # a sum in f32, not isfinite(): that allocates ~2 bytes a weight
        check(all(math.isfinite(float(t.sum(dtype=torch.float32)))
                  for t in tree_leaves(params)), "non-finite parameters")

        # -- prefill -------------------------------------------------------
        shape = ShapeSpec("prefill", PREFILL_S, 1, "prefill")
        batch = make_inputs(cfg, shape, device=dev)
        prefill = make_prefill_step(cfg)
        zero_counts(fa, sk)
        torch.cuda.synchronize()
        tok = prefill(params, batch)
        torch.cuda.synchronize()
        launches = {"flash_attention": dict(fa.launches_by),
                    "ssd_intra": dict(sk.launches_by)}
        n_groups = len(range(0, cfg.num_layers, cfg.attn_every))
        print(f"model prefill launches: {launches}")
        check(launches == {
            "flash_attention": {"wgmma_bf16": n_groups, "simt": 0},
            "ssd_intra": {"wgmma_bf16": cfg.num_layers, "simt": 0}},
            f"prefill launched {launches}, expected {n_groups} flash and "
            f"{cfg.num_layers} SSD launches, all wgmma_bf16")
        check(tok.shape == (1,) and 0 <= int(tok) < cfg.vocab_size,
              f"prefill's next token {tok}")
        walls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ms = 1e3 * sum(walls) / len(walls)
        flops = step_flops(cfg, shape).total_mxu
        mfu = flops / (ms / 1e3) / PEAK_OPS_PER_S["bf16"]
        kernel_share = (n_groups * kernel_ms["flash_attention"]
                        + cfg.num_layers * kernel_ms["ssd_intra"]) / ms
        print(f"model prefill: {cfg.name}, S {PREFILL_S}, B 1: "
              + ", ".join(f"{w * 1e3:.2f}" for w in walls)
              + f" ms ({ms:.2f} ms mean, {PREFILL_S / ms * 1e3:,.0f} "
              f"tokens/s); {flops / 1e12:.3f} TFLOP (step_flops, "
              f"prefill) -> MFU {mfu:.3f} of 989 TFLOP/s bf16 [{card}]; "
              f"flash x{n_groups} at {kernel_ms['flash_attention']:.4f} ms "
              f"+ SSD x{cfg.num_layers} at {kernel_ms['ssd_intra']:.4f} ms "
              f"(phase 10's times) = {kernel_share:.1%} of the step")
        profile_forward(torch, lambda: prefill(params, batch), ms)
        del batch
        marks = {"init and prefill": time.perf_counter()}
        peaks = {"init": param_bytes,
                 "prefill": torch.cuda.max_memory_allocated(dev) - base}
        torch.cuda.reset_peak_memory_stats(dev)

        # -- decode: the serve loop ---------------------------------------
        warm = decode_batch(cfg, DECODE_B, DECODE_CTX, dev)
        generate(cfg, params, warm, 2)
        del warm
        dbatch = decode_batch(cfg, DECODE_B, DECODE_CTX, dev)
        cache_bytes = sum(v.numel() * v.element_size()
                          for k, v in dbatch.items() if k.endswith(
                              ("_cache", "_state")))
        zero_counts(fa, sk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(cfg, params, dbatch, DECODE_TOKENS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(toks.shape == (DECODE_B, DECODE_TOKENS)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              "decoded tokens out of range")
        check(fa.launches == 0 and sk.launches == 0,
              "decode launched a prefill kernel")
        bound_ms = (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
        tok_ms = dt / DECODE_TOKENS * 1e3
        print(f"decoded {DECODE_TOKENS} tokens x {DECODE_B} seqs in "
              f"{dt:.2f}s ({DECODE_TOKENS * DECODE_B / dt:.1f} tok/s)")
        print("sample:", toks[0, :16].cpu().numpy())
        print(f"model decode: {cfg.name}, B {DECODE_B}, ctx {DECODE_CTX}: "
              f"{tok_ms:.2f} ms a token, {DECODE_TOKENS * DECODE_B / dt:.1f} "
              f"tok/s; bound {bound_ms:.2f} ms ({param_bytes / 1e9:.2f} GB "
              f"of parameters + {cache_bytes / 1e9:.2f} GB of KV and SSM "
              f"caches over 3.35 TB/s), {bound_ms / tok_ms:.1%} of it "
              f"[{card}]")
        profile_decode(torch, lambda: generate(cfg, params, dbatch, 2))
        del dbatch
        marks["decode"] = time.perf_counter()
        peaks["decode"] = torch.cuda.max_memory_allocated(dev) - base
        print(f"model: peak device memory {max(peaks.values()) / 2**30:.3f} "
              f"GiB over the {base / 2**30:.3f} held before (parameters "
              f"{peaks['init'] / 2**30:.3f}, prefill "
              f"{peaks['prefill'] / 2**30:.3f}, decode "
              f"{peaks['decode'] / 2**30:.3f}) [{card}]")

        # -- correctness at full width -------------------------------------
        hb = wgmma_heads(cfg.ssm_head_dim, cfg.ssm_nheads, cfg.ssm_ngroups)
        group_check(torch, dev, cfg, params, hb)
        decode_vs_forward(torch, dev, cfg, params, hb)
        torch.cuda.empty_cache()
        marks["checks at full width"] = time.perf_counter()

        # -- the other families, 2 layers at published width ---------------
        for model, S in FAMILY_MODELS:
            family_check(torch, dev, model, S)
    marks["families"] = time.perf_counter()
    split, t = [], t_phase
    for name, mark in marks.items():
        split.append(f"{name} {mark - t:.2f}")
        t = mark
    print(f"model phase 11: {time.perf_counter() - t_phase:.2f} s ("
          + ", ".join(split) + " s)")
    measured = {"prefill_ms": ms, "prefill_peak": peaks["prefill"],
                "decode_peak": peaks["decode"], "decode_tok_ms": tok_ms}
    return {"flash_attention": launches["flash_attention"]["wgmma_bf16"],
            "ssd_intra": launches["ssd_intra"]["wgmma_bf16"]}, params, \
        measured


def profile_forward(torch, fn, ms: float) -> None:
    """torch.profiler over one more prefill: device busy time and idle
    share against the timed mean, and the flash and SSD kernels' share
    of the device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, ops = device_times(prof.key_averages())
    if not kernels:
        print("model prefill profile: device time not measured (the "
              "profiler saw no device activity)")
        return
    busy = sum(d[0] for d in kernels) / 1e3
    flash = sum(d[0] for d in kernels if "flash" in d[2]) / 1e3
    ssd = sum(d[0] for d in kernels if "ssd" in d[2]) / 1e3
    print(f"model prefill profile: device busy {busy:.2f} ms of {ms:.2f} ms "
          f"(idle share {1 - busy / ms:.3f}), {sum(d[1] for d in kernels)} "
          f"kernels; flash {flash:.2f} ms ({flash / busy:.1%}), SSD "
          f"intra-chunk {ssd:.2f} ms ({ssd / busy:.1%}) of device time; "
          f"device time by op: {top_times(ops, 8)}")


def profile_decode(torch, fn) -> None:
    """torch.profiler over 2 decode tokens: host kernel launches and
    device busy time a token."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    n_launch = sum(e.count for e in averages if "LaunchKernel" in e.key)
    kernels, ops = device_times(averages)
    busy = sum(d[0] for d in kernels) / 1e3
    print(f"model decode profile: {n_launch / 2:.0f} host kernel launches "
          f"a token; device busy {busy / 2:.2f} ms a token of "
          f"{wall / 2:.2f} ms under the profiler; device time by op over "
          f"2 tokens: {top_times(ops, 6)}")


def device_times(averages) -> tuple[list, list]:
    """(kernels, ops) of a profile's `key_averages()`, each [(device µs,
    count, name)] largest first: the device's own events (their sum is
    its busy time), and the host ops with the device time of the kernels
    they launched (which counts that time a second time)."""
    kernels, ops = [], []
    for e in averages:
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            on_device = getattr(e.device_type, "name", "") == "CUDA"
            (kernels if on_device else ops).append((us, e.count, e.key))
    return sorted(kernels, reverse=True), sorted(ops, reverse=True)


def top_times(rows: list, n: int) -> str:
    return "; ".join(f"{k[:40]} {us / 1e3:.2f} ms x{c}"
                     for us, c, k in rows[:n])


def group_check(torch, dev, cfg, params, hb: int) -> None:
    """Correctness (a): the shared block and layers 0-5 at full width,
    S 512, B 1, on the card through the kernels against the CPU through
    the plain versions on the same parameters: in f32 (the card's bf16
    parameters upcast; the SIMT kernels) to `close_rows`' limit, in bf16
    (the wgmma kernels) with `bf16_close`.  Both limits must reject the
    three `model_mutants`, run on the card."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, make_inputs
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    from repro_torch.models.common import tree_map
    from repro_torch.models.ssm_models import (_mamba_stack,
                                               _shared_attn_apply, _slice)
    t0 = time.perf_counter()
    s, e = 0, cfg.attn_every
    sub16 = {"shared_attn": params["shared_attn"],
             "layers": _slice(params["layers"], s, e)}
    sub32 = tree_map(lambda t: t.float(), sub16)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = make_inputs(cfg, ShapeSpec("g", GROUP_S, 1, "prefill"), seed=1,
                       device=dev)["tokens"]
    x16 = params["embed"][toks]

    def group(c, p, x):
        pos = torch.arange(x.shape[1], device=x.device)
        x = _shared_attn_apply(c, p["shared_attn"], x, pos)
        return _mamba_stack(c, p["layers"], x)

    def on_card(c, p, x):
        """The group on the card and its mutants, each on the CPU."""
        zero_counts(flash_attention_kernel, ssd_intra_kernel)
        out = group(c, p, x).cpu()
        variant = "wgmma_bf16" if c.dtype == "bfloat16" else "simt"
        check((flash_attention_kernel.launches_by[variant],
               ssd_intra_kernel.launches_by[variant]) == (1, e),
              f"the group did not run its {variant} kernels")
        mutants = {}
        for name, patch in model_mutants(torch, hb).items():
            with patch:
                mutants[name] = group(c, p, x).cpu()
        return out, mutants

    name = f"{cfg.name} shared block + layers {s}-{e - 1}, S {GROUP_S}"
    cpu32 = group(cfg32, tree_map(lambda t: t.cpu(), sub32), x16.float().cpu())
    card32, mutants32 = on_card(cfg32, sub32, x16.float())
    close_rows(torch, f"{name}, f32, card vs CPU", card32, cpu32, mutants32)
    cpu16 = group(cfg, tree_map(lambda t: t.cpu(), sub16), x16.cpu())
    card16, mutants16 = on_card(cfg, sub16, x16)
    bf16_close(torch, f"{name}, bf16", card16, cpu16, cpu32, mutants16)
    print(f"model group check: {time.perf_counter() - t0:.2f} s")


def rel_l2(torch, got, want) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def bf16_close(torch, name: str, card, plain, truth, mutants: dict) -> float:
    """A bf16 model output of several layers: each layer's bf16 rounding
    puts any bf16 route a few % (relative L2) from the f32 result, past
    `close_rows`' limit on whichever device it runs, so the card's
    output is held to lie no further from the CPU's f32 output `truth`
    than BF16_MODEL_FACTOR times the CPU's plain bf16 output does; the
    limit must reject each of `mutants`.  Returns the card's distance."""
    kernel, ref = rel_l2(torch, card, truth), rel_l2(torch, plain, truth)
    limit = BF16_MODEL_FACTOR * ref
    wrong = {k: rel_l2(torch, v, truth) for k, v in mutants.items()}
    print(f"{name}: relative L2 from the CPU's f32 output: card "
          f"{kernel:.4e}, CPU's plain bf16 {ref:.4e}, card vs CPU "
          f"{rel_l2(torch, card, plain):.4e}; limit {limit:.4e}; mutants "
          + ", ".join(f"{k} {v:.4e}" for k, v in wrong.items()))
    check(math.isfinite(kernel) and kernel <= limit,
          f"{name}: the card's output is {kernel:.4e} from the f32 result, "
          f"past {limit:.4e}")
    for what, v in wrong.items():
        check(v > limit, f"{name}: the limit passes a {what} output")
    return kernel


def decode_vs_forward(torch, dev, cfg, params, hb: int) -> None:
    """Correctness (b): 64 tokens decoded one by one through the plain
    decode path against one forward over the same 64 tokens through both
    kernels (Q = 64, S = 64), all 81 layers, in bf16 (the wgmma kernels)
    and, as a witness that the bf16 gap is rounding and not a mismatch of
    the two paths, in f32 on the same parameters upcast (the SIMT
    kernels).  Prints the largest logit difference over the forward's
    logit RMS and the argmax agreement, and holds each to its limit,
    past which the three mutants must land."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, make_inputs
    from repro_torch.models.common import tree_map
    t0 = time.perf_counter()
    toks = make_inputs(cfg, ShapeSpec("d", DECODE_CHECK_T, 1, "prefill"),
                       seed=2, device=dev)["tokens"]
    one_dtype_decode_vs_forward(torch, dev, cfg, params, hb, toks,
                                DECODE_VS_FORWARD_LIMIT)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    one_dtype_decode_vs_forward(torch, dev, cfg32, params32, hb, toks,
                                DECODE_VS_FORWARD_F32_LIMIT)
    del params32
    torch.cuda.empty_cache()
    print(f"model decode vs forward: {time.perf_counter() - t0:.2f} s")


def one_dtype_decode_vs_forward(torch, dev, cfg, params, hb: int, toks,
                                limit: float) -> None:
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    from repro_torch.launch.serve import decode_batch
    from repro_torch.models import decode_step, forward
    T = toks.shape[1]
    batch = decode_batch(cfg, 1, T, dev)
    dec = []
    for t in range(T):
        batch["tokens"] = toks[:, t:t + 1]
        batch["cache_index"] = torch.full((), t, dtype=torch.int32,
                                          device=dev)
        logits, _ = decode_step(cfg, params, batch)
        dec.append(logits[:, 0].float())
    dec = torch.stack(dec, 1)
    del batch
    zero_counts(flash_attention_kernel, ssd_intra_kernel)
    full = forward(cfg, params, {"tokens": toks}).float()
    torch.cuda.synchronize()
    n_groups = len(range(0, cfg.num_layers, cfg.attn_every))
    variant = "wgmma_bf16" if cfg.dtype == "bfloat16" else "simt"
    check((flash_attention_kernel.launches_by[variant],
           ssd_intra_kernel.launches_by[variant])
          == (n_groups, cfg.num_layers),
          f"the {T}-token {cfg.dtype} forward did not run its {variant} "
          f"kernels")
    rms = float(full.pow(2).mean().sqrt())

    def err(t):
        return float((t - dec).abs().max()) / rms
    e = err(full)
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    wrong = {}
    for name, patch in model_mutants(torch, hb).items():
        with patch:
            wrong[name] = err(forward(cfg, params, {"tokens": toks}).float())
    print(f"model decode vs forward: {cfg.name}, {cfg.dtype}, {T} tokens, "
          f"all {cfg.num_layers} layers: max |diff| {e * rms:.4e} = "
          f"{e:.4e} of the logit RMS {rms:.4f}; argmax agrees at "
          f"{agree:.1%} of positions; mutants "
          + ", ".join(f"{k} {v:.4f}" for k, v in wrong.items())
          + f"; limit {limit}")
    check(math.isfinite(e) and e <= limit,
          f"{cfg.dtype} decode differs from forward by {e:.4e} of the logit "
          f"RMS, past {limit}")
    for name, v in wrong.items():
        check(v > limit, f"the {cfg.dtype} decode-vs-forward limit passes a "
              f"{name} forward")


def family_check(torch, dev, model: str, S: int) -> None:
    """A family at published width and 2 layers (2 encoder layers for
    whisper): forward and 4 decode steps on the card against the CPU's
    plain route on the same parameters and inputs (`bf16_close`, the
    CPU's f32 run on the same values as the truth, a zeroed output as
    the mutant), with the kernels' launches counted."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config, make_inputs
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models.common import tree_map
    t0 = time.perf_counter()
    fa, sk = flash_attention_kernel, ssd_intra_kernel
    cfg = get_config(model)
    cfg = dataclasses.replace(cfg, num_layers=2,
                              encoder_layers=min(cfg.encoder_layers, 2))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                         device=dev)
    runs = {"card": (cfg, params),
            "cpu": (cfg, tree_map(lambda t: t.cpu(), params)),
            "cpu f32": (cfg32, tree_map(lambda t: t.cpu().float(), params))}

    def inputs(batch, run):
        out = {k: v.to("cpu", copy=True) if run != "card" else v
               for k, v in batch.items()}
        if run == "cpu f32":
            out = {k: v.float() if v.dtype == torch.bfloat16 else v
                   for k, v in out.items()}
        return out

    batch = make_inputs(cfg, ShapeSpec("p", S, 1, "prefill"), device=dev)
    zero_counts(fa, sk)
    outs = {run: forward(c, p, inputs(batch, run))
            for run, (c, p) in runs.items()}
    fwd = (dict(fa.launches_by), dict(sk.launches_by))
    name = f"{model} (2 layers)"
    bf16_close(torch, f"{name} forward, S {S}", outs["card"].cpu(),
               outs["cpu"], outs["cpu f32"],
               {"zeroed": torch.zeros_like(outs["cpu"])})
    dbatch = make_inputs(cfg, ShapeSpec("d", 64, 1, "decode"), device=dev)
    batches = {run: inputs(dbatch, run) for run in runs}
    zero_counts(fa, sk)
    for i in range(4):
        outs = {run: decode_step(c, p, batches[run])[0]
                for run, (c, p) in runs.items()}
        bf16_close(torch, f"{name} decode step {i}", outs["card"].cpu(),
                   outs["cpu"], outs["cpu f32"],
                   {"zeroed": torch.zeros_like(outs["cpu"])})
        for b in batches.values():
            b["cache_index"] = b["cache_index"] + 1
    torch.cuda.synchronize()
    dec = (dict(fa.launches_by), dict(sk.launches_by))
    want_fwd = {"llama3.2-3b": (2, 0), "mamba2-780m": (0, 2),
                "whisper-small": (6, 0)}[model]
    want_dec = (8, 0) if model == "whisper-small" else (0, 0)
    print(f"model family {model}: forward launches flash {fwd[0]}, SSD "
          f"{fwd[1]}; 4 decode steps flash {dec[0]}, SSD {dec[1]}; "
          f"{time.perf_counter() - t0:.2f} s")
    for (f, s), (wf, ws) in ((fwd, want_fwd), (dec, want_dec)):
        check(f == {"wgmma_bf16": wf, "simt": 0}
              and s == {"wgmma_bf16": ws, "simt": 0},
              f"{model}: launches {f}, {s}, expected {wf} flash and {ws} "
              "SSD on wgmma_bf16")


# ---------------------------------------------------------------------------
# 12. training at full width
# ---------------------------------------------------------------------------
#: zamba2-7b at full width, one sequence of 4,096 tokens a step: one
#: warm-up step, TRAIN_TIMED timed ones, one under the profiler
TRAIN_S, TRAIN_TIMED = 4096, 3
#: the reference's own large-model optimizer options (bf16 first moment,
#: factored second moment): with f32 moments the state alone (parameters,
#: gradients, m and v) is 81.5 GB
TRAIN_OPT = {"moment_dtype": "bfloat16", "factored_v": True,
             "warmup_steps": 1}
#: the other families at published width, 2 layers, f32: (model, S)
TRAIN_FAMILY_MODELS = FAMILY_MODELS


def grad_mutants(torch):
    """Wrong backwards the gradient checks must reject, each a patch of
    `kernels.grad`: flash with dq set to 0, the SSD without its d dacs
    term (the path to A_log and dt through the decays), and the SSD
    backward with each head's decays taken from the next head."""
    from unittest import mock

    from repro_torch.kernels import grad
    flash_bwd, ssd_bwd = grad.flash_bwd, grad.ssd_intra_bwd

    def dq_zeroed(*a, **kw):
        dq, dk, dv = flash_bwd(*a, **kw)
        return torch.zeros_like(dq), dk, dv

    def no_ddacs(*a):
        dx, ddt, ddacs, db, dc = ssd_bwd(*a)
        return dx, ddt, torch.zeros_like(ddacs), db, dc

    def next_head(x, dt, dacs, b, c, dy):
        nh = dt.shape[-1]
        nxt = (torch.arange(nh, device=dt.device) + 1) % nh
        return ssd_bwd(x, dt, dacs[..., nxt], b, c, dy)
    return {"dq-zeroed": mock.patch.object(grad, "flash_bwd", dq_zeroed),
            "d-dacs-dropped": mock.patch.object(grad, "ssd_intra_bwd",
                                                no_ddacs),
            "next-head-decays": mock.patch.object(grad, "ssd_intra_bwd",
                                                  next_head)}


def plain_route(torch):
    """Autograd through the kernels' plain versions, on any device: the
    kernel API's entry points patched to call them."""
    from unittest import mock

    from repro_torch.kernels import ops, ref
    return (mock.patch.object(ops, "flash", ref.ref_attention),
            mock.patch.object(ops, "ssd_intra", ref.ref_ssd_intra))


def leaf_paths(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaf_paths(v, f"{path}[{k!r}]"))
        return out
    return {path: tree}


def grads_close(torch, name: str, got: dict, want: dict,
                mutants: dict) -> float:
    """`close_rows`' limit (2^-6·|w| + 2^-5 of the row's RMS) on every
    leaf of a gradient tree: fails unless each leaf of `got` is finite
    and within it of `want`'s, and unless every tree of `mutants` puts
    some element of some leaf past it.  Returns the largest |diff| over
    the row RMS."""
    got, want = leaf_paths(got), leaf_paths(want)
    check(set(got) == set(want), f"{name}: leaves differ")
    worst, rejected = 0.0, {k: 0 for k in mutants}
    mutants = {k: leaf_paths(v) for k, v in mutants.items()}
    for path, w in want.items():
        w = w.double().cpu()
        rms = w.pow(2).mean(-1, keepdim=True).sqrt()
        limit = BF16_RTOL * w.abs() + BF16_ROW_ATOL * rms
        g = got[path].double().cpu()
        check(bool(torch.isfinite(g).all()), f"{name} {path}: non-finite")
        n_bad = int(((g - w).abs() > limit).sum())
        check(n_bad == 0, f"{name} {path}: {n_bad} elements beyond the "
              f"limit (max |diff| {float((g - w).abs().max()):.3e})")
        worst = max(worst, float(((g - w).abs() / rms.clamp_min(
            1e-30)).max()))
        for k, m in mutants.items():
            rejected[k] += int(((m[path].double().cpu() - w).abs()
                                > limit).sum())
    print(f"{name}: {len(want)} leaves, max |diff| {worst:.3e} of the row "
          f"RMS; the limit rejects, of the elements: " + ", ".join(
              f"{k} {n:,d}" for k, n in rejected.items()))
    for k, n in rejected.items():
        check(n > 0, f"{name}: the limit passes the {k} gradients")
    return worst


def grads_rel(torch, got: dict, want: dict) -> dict:
    """Relative L2 distance of each leaf of `got` from `want`'s."""
    got, want = leaf_paths(got), leaf_paths(want)
    return {p: rel_l2(torch, got[p].cpu(), want[p].cpu()) for p in want}


def rms_over_leaves(d: dict) -> float:
    return math.sqrt(sum(v * v for v in d.values()) / len(d))


def group_grads(torch, cfg, sub, x, cot):
    """Gradients of sum(cot ∘ group(x)) for every leaf of `sub` (the
    shared block and a slice of layers), taken as the train step takes
    them: per-layer leaves, each layer body under remat."""
    from repro_torch.models.common import remat, tree_map
    from repro_torch.models.ssm_models import _mamba_stack, _shared_attn_apply
    from repro_torch.train.steps import grad_leaves
    grads = tree_map(torch.zeros_like, sub)
    model, leaves = grad_leaves(sub, grads)
    pos = torch.arange(x.shape[1], device=x.device)
    y = remat(cfg, _shared_attn_apply, cfg, model["shared_attn"], x, pos)
    y = _mamba_stack(cfg, model["layers"], y)
    (y.float() * cot).sum().backward(inputs=leaves)
    return grads


def train_group_check(torch, dev, cfg, params) -> None:
    """Correctness (a) of training at full width: the gradients of one
    layer group (the shared block and layers 0-5, S 512) for every leaf.
    f32 on the card: through the Functions (the SIMT kernels, run again
    in the recompute) against autograd through the plain versions on the
    card, every leaf within `close_rows`' limit, which must reject the
    three `grad_mutants`.  bf16: the wgmma kernels' gradients no further from the f32 ones (RMS over leaves of each
    leaf's relative L2 distance) than BF16_MODEL_FACTOR times the CPU's
    plain bf16 route's, a limit the mutants must pass."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, make_inputs
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    from repro_torch.models.common import tree_map
    from repro_torch.models.ssm_models import _slice
    t0 = time.perf_counter()
    fa, sk = flash_attention_kernel, ssd_intra_kernel
    e = cfg.attn_every
    sub16 = {"shared_attn": params["shared_attn"],
             "layers": _slice(params["layers"], 0, e)}
    sub32 = tree_map(lambda t: t.float(), sub16)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = make_inputs(cfg, ShapeSpec("g", GROUP_S, 1, "prefill"), seed=4,
                       device=dev)["tokens"]
    x16 = params["embed"][toks].detach()
    gen = torch.Generator(device=dev).manual_seed(5)
    cot = torch.randn(x16.shape, generator=gen, device=dev) \
        / math.sqrt(x16.numel())
    name = f"{cfg.name} gradients, shared block + layers 0-{e - 1}, " \
        f"S {GROUP_S}"

    def kernel_route(c, p, x, variant):
        zero_counts(fa, sk)
        out = group_grads(torch, c, p, x, cot)
        torch.cuda.synchronize()
        got = (fa.launches_by[variant], sk.launches_by[variant])
        check(got == (2, 2 * e) and fa.launches == 2
              and sk.launches == 2 * e,
              f"{name}, {c.dtype}: launches {fa.launches_by}, "
              f"{sk.launches_by}, expected 2 flash and {2 * e} SSD on "
              f"{variant} (forward and recompute)")
        mutants = {}
        for k, patch in grad_mutants(torch).items():
            with patch:
                mutants[k] = group_grads(torch, c, p, x, cot)
        return out, mutants

    marks = [time.perf_counter()]
    card32, mut32 = kernel_route(cfg32, sub32, x16.float(), "simt")
    a, b = plain_route(torch)
    with a, b:
        zero_counts(fa, sk)
        plain32 = group_grads(torch, cfg32, sub32, x16.float(), cot)
        check(fa.launches == 0 and sk.launches == 0,
              "the plain route launched a kernel")
    grads_close(torch, f"{name}, f32, kernels vs plain on the card",
                card32, plain32, mut32)
    del mut32, card32

    card16, mut16 = kernel_route(cfg, sub16, x16, "wgmma_bf16")
    marks.append(time.perf_counter())
    with a, b:
        cpu16 = group_grads(torch, cfg, tree_map(lambda t: t.cpu(), sub16),
                            x16.cpu(), cot.cpu())
    marks.append(time.perf_counter())
    truth = tree_map(lambda t: t.cpu(), plain32)
    kern, ref = grads_rel(torch, card16, truth), grads_rel(torch, cpu16, truth)
    limit = BF16_MODEL_FACTOR * rms_over_leaves(ref)
    wrong = {k: rms_over_leaves(grads_rel(torch, v, truth))
             for k, v in mut16.items()}
    ratio = max(kern, key=lambda p: kern[p] / max(ref[p], 1e-30))
    print(f"{name}, bf16: RMS over {len(kern)} leaves of the relative L2 "
          f"from the f32 gradients: card {rms_over_leaves(kern):.4e}, CPU's "
          f"plain bf16 {rms_over_leaves(ref):.4e}; limit {limit:.4e}; "
          f"largest leaf ratio card/CPU {kern[ratio] / ref[ratio]:.3f} "
          f"({ratio}: {kern[ratio]:.4e} vs {ref[ratio]:.4e}); mutants "
          + ", ".join(f"{k} {v:.4e}" for k, v in wrong.items()))
    check(rms_over_leaves(kern) <= limit,
          f"{name}, bf16: the card's gradients lie "
          f"{rms_over_leaves(kern):.4e} from the f32 ones, past {limit:.4e}")
    for k, v in wrong.items():
        check(v > limit, f"{name}, bf16: the limit passes the {k} gradients")
    print(f"train group check: {time.perf_counter() - t0:.2f} s (the "
          f"card's 10 backwards {marks[1] - marks[0]:.2f} s, the CPU's bf16 "
          f"one {marks[2] - marks[1]:.2f} s)")


def layer_slices(tree) -> dict:
    """{(path, layer): tensor} over every leaf, a stacked leaf (under
    `train.steps.STACKED`) by layer."""
    from repro_torch.train.steps import STACKED
    out = {}
    for path, t in leaf_paths(tree).items():
        stacked = any(f"[{k!r}]" in path for k in STACKED)
        for i, s in enumerate(t.unbind(0) if stacked else (t,)):
            out[(path, i)] = s
    return out


def layer_sums(torch, tree) -> dict:
    """{(path, layer): f64 sum}: a fingerprint that costs no copy."""
    return {k: float(torch.sum(s, dtype=torch.float64))
            for k, s in layer_slices(tree).items()}


def train_phase(torch, dev, card: str, params, poller) -> tuple:
    """Phase 12: zamba2-7b at full width through the port's `Trainer`
    (one warm-up step, 3 timed, one under the profiler), on phase 11's
    parameters, with its gradient checks (a) and (b); then (c), three
    families at published width, 2 layers, each an f32 train step
    against the CPU and a crash restart through checkpoints, and (d),
    granite-3-2b's train step on the backward kernels.  `poller`
    (a `CounterPoller`) polls the card over the timed steps, phase 15's
    train window.  Returns each model kernel's launches a full-width
    train step, the timed steps' mean s and the steps' peak device memory
    less what earlier phases still hold (phase 14 holds the dry run to
    them), and the train window: its bounds, steps and launches."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.flops.accounting import train_step_flops
    from repro_torch.kernels import grad
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import (ssd_intra_bwd_kernel,
                                              ssd_intra_kernel)
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer
    import gc
    t_phase = time.perf_counter()
    fa, sk = flash_attention_kernel, ssd_intra_kernel
    sb = ssd_intra_bwd_kernel
    cfg = get_config(SERVE_MODEL)
    train_group_check(torch, dev, cfg, params)
    marks = {"group gradients": time.perf_counter()}

    # -- the full-width train steps ---------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # what else is held besides the parameters (earlier phases' tensors)
    others = torch.cuda.memory_allocated(dev) - sum(
        t.numel() * t.element_size() for t in leaf_paths(params).values())
    shape = ShapeSpec("train", TRAIN_S, 1, "train")
    before = layer_sums(torch, params)
    n_steps = 1 + TRAIN_TIMED + 1
    counts, prof = [], profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
    # what can make one step slower than the others: the caching
    # allocator's retries (a failed cudaMalloc frees every cached block,
    # synchronizing) and cudaMalloc/cudaFree calls, and Python's cyclic GC
    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    gc_s, gc_t0, host = [0.0, 0], [0.0], []

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]
            gc_s[1] += info["generation"] == 2

    def snapshot():
        st = torch.cuda.memory_stats(dev)
        return ([st.get(k, 0) for k in alloc_keys]
                + [st.get("reserved_bytes.all.current", 0), *gc_s])

    window = {}

    def tally():
        return (dict(fa.launches_by), dict(sk.launches_by),
                grad.flash_bwd_routes(), dict(sb.launches_by),
                grad.ssd_bwd_routes())

    def hook(step):
        counts.append(tally())
        host.append(snapshot())
        if step == 1:                   # phase 15's window: the timed steps
            torch.cuda.synchronize()
            poller.start()
            window["t0"] = time.perf_counter()
        if step == n_steps - 1:
            torch.cuda.synchronize()
            window["t1"] = time.perf_counter()
            poller.stop()
            prof.__enter__()
    handed = [params]
    with tempfile.TemporaryDirectory() as ck:
        trainer = Trainer(
            cfg, shape, adamw.OptConfig(**TRAIN_OPT),
            TrainConfig(total_steps=n_steps, ckpt_every=0, ckpt_dir=ck,
                        log_every=1, monitor=False, device=str(dev)),
            fault_hook=hook, params_fn=handed.pop)
        zero_counts(fa, sk, sb)
        gc.callbacks.append(on_gc)
        try:
            out = trainer.run()
        finally:
            gc.callbacks.remove(on_gc)
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    counts.append(tally())
    host.append(snapshot())
    peak = torch.cuda.max_memory_allocated(dev)
    n_groups = len(range(0, cfg.num_layers, cfg.attn_every))
    want = (2 * n_groups, 2 * cfg.num_layers)
    per_step = []
    for i in range(n_steps):
        f0, s0, b0, l0, r0 = counts[i]
        f1, s1, b1, l1, r1 = counts[i + 1]
        step = ({k: f1[k] - f0[k] for k in f1}, {k: s1[k] - s0[k] for k in s1})
        check(step == ({"wgmma_bf16": want[0], "simt": 0},
                       {"wgmma_bf16": want[1], "simt": 0}),
              f"train step {i}: launches {step}, expected {want[0]} flash "
              f"and {want[1]} SSD on wgmma_bf16 (forward and recompute)")
        bwd = {k: b1[k] - b0[k] for k in b1}
        check(bwd == {"kernel": 0, "plain": n_groups},
              f"train step {i}: attention backward calls {bwd}, expected "
              f"{n_groups} on the plain route (hd {cfg.head_dim})")
        ssd_bwd = {k: r1[k] - r0[k] for k in r1}
        ssd_launched = {k: l1[k] - l0[k] for k in l1}
        check(ssd_bwd == {"kernel": cfg.num_layers, "plain": 0}
              and ssd_launched == {k: cfg.num_layers for k in l1},
              f"train step {i}: SSD backward calls {ssd_bwd} and launches "
              f"{ssd_launched}, expected {cfg.num_layers} on the kernel "
              f"route, each of its three kernels {cfg.num_layers} times")
        per_step.append(step + (sum(ssd_launched.values()),))
    losses = [m["loss"] for m in out["metrics"]]
    check(out["final_step"] == n_steps and len(losses) == n_steps
          and all(math.isfinite(v) for v in losses),
          f"the trainer ended at step {out['final_step']} with losses "
          f"{losses}")
    times = [t.step_time_s for t in trainer.history]
    s = sum(times[1:1 + TRAIN_TIMED]) / TRAIN_TIMED
    model_fl = train_step_flops(cfg, shape, remat=False).total_mxu
    exec_fl = train_step_flops(cfg, shape, remat=True,
                               executed=True).total_mxu
    peak_rate = PEAK_OPS_PER_S["bf16"]
    print(f"train: {cfg.name} at full width, S {TRAIN_S}, B 1, bf16, "
          f"AdamW {TRAIN_OPT}: steps "
          + ", ".join(f"{t:.3f}" for t in times)
          + f" s (warm-up, {TRAIN_TIMED} timed, profiled); {s:.3f} s a "
          f"step, {TRAIN_S / s:,.0f} tokens/s; {model_fl / 1e12:.2f} TFLOP "
          f"a step (train_step_flops, remat=False) -> MFU "
          f"{model_fl / s / peak_rate:.3f} of 989 TFLOP/s bf16; executed "
          f"with remat's recompute {exec_fl / 1e12:.2f} TFLOP "
          f"({exec_fl / model_fl:.4f}x) -> {exec_fl / s / peak_rate:.3f}; "
          f"losses " + ", ".join(f"{v:.4f}" for v in losses)
          + f"; peak device memory {peak / 2**30:.3f} GiB [{card}]")
    print(f"train launches a step: flash {want[0]}, SSD {want[1]} "
          f"wgmma_bf16 (forward {n_groups} and {cfg.num_layers}, the same "
          f"again in the recompute; the backwards launch none of these); "
          f"attention backward {n_groups} calls, all on the plain route "
          f"(hd {cfg.head_dim}); SSD backward {cfg.num_layers} calls, all "
          f"on the kernel route, {per_step[1][2]} launches (dG, dX, dC/dB "
          f"{cfg.num_layers} each)")
    deltas = [[b - a for a, b in zip(host[i], host[i + 1])]
              for i in range(n_steps)]
    print("train steps, host side, each step (hook to hook): allocator "
          "retries " + str([r[0] for r in deltas]) + ", cudaMalloc "
          + str([r[1] for r in deltas]) + ", cudaFree "
          + str([r[2] for r in deltas]) + ", reserved after " + ", ".join(
              f"{h[3] / 2**30:.2f}" for h in host[1:])
          + " GiB; Python GC " + ", ".join(f"{r[4]:.3f}" for r in deltas)
          + " s, of which full (gen-2) collections "
          + str([r[5] for r in deltas]))
    t_prof = time.perf_counter()
    kernels, ops = device_times(prof.key_averages())
    print(f"train profile: read in {time.perf_counter() - t_prof:.2f} s")
    if kernels:
        # one window: the profiled step's device time over its own wall
        # time (the profiler's own cost is in that time)
        busy = sum(d[0] for d in kernels) / 1e6
        flash = sum(d[0] for d in kernels if "flash" in d[2]) / 1e6
        ssd = sum(d[0] for d in kernels if "ssd" in d[2]) / 1e6
        wall = times[-1]
        print(f"train profile: the profiled step, device busy {busy:.3f} s "
              f"of its {wall:.3f} s (idle share {1 - busy / wall:.3f}; the "
              f"timed steps' mean {s:.3f} s), "
              f"{sum(d[1] for d in kernels)} kernels; flash {flash * 1e3:.2f} "
              f"ms, SSD intra-chunk {ssd * 1e3:.2f} ms; device time by "
              f"op: {top_times(ops, 10)}")
    else:
        print("train profile: device time not measured (the profiler saw "
              "no device activity)")
    del prof

    # -- (b) after the full-width steps ------------------------------------
    grads = layer_slices(trainer.step_fn.grads)
    bad = [k for k, v in layer_sums(torch, trainer.step_fn.grads).items()
           if not math.isfinite(v)]
    check(not bad, f"non-finite gradients: {bad[:5]}")
    zero = [k for k, g in grads.items() if not bool((g != 0).any())]
    check(not zero, f"gradients that are zero throughout: {zero[:5]}")
    after = layer_sums(torch, params)
    # a bf16 vector of 1.0s (the norms, D) moves by ~lr = 3e-4 a step,
    # less than half its ulp (2^-8): it stays; matrices and f32 leaves move
    slices = layer_slices(params)
    must = {k for k, t in slices.items()
            if t.dtype == torch.float32 or t.ndim >= 2}
    unmoved = sorted(k for k in must if after[k] == before[k])
    check(not unmoved, f"parameters that did not move: {unmoved[:5]}")
    still = sorted({p for p, i in before if after[(p, i)] == before[(p, i)]})
    print(f"train checks: every gradient finite and non-zero over "
          f"{len(grads)} leaves and layers; all {len(must)} matrices and "
          f"f32 leaves (by layer) moved; unmoved bf16 vectors: {still}")
    del grads, trainer
    marks["full-width steps"] = time.perf_counter()

    # -- (c) the other families, 2 layers, f32 -----------------------------
    for model, S in TRAIN_FAMILY_MODELS:
        train_family_check(torch, dev, model, S)
    marks["families"] = time.perf_counter()

    # -- (d) granite-3-2b's train step: the backward kernels' main path ----
    granite_step_check(torch, dev, card)
    marks["granite step"] = time.perf_counter()
    split, t = [], t_phase
    for name, mark in marks.items():
        split.append(f"{name} {mark - t:.2f}")
        t = mark
    print(f"train phase 12: {time.perf_counter() - t_phase:.2f} s ("
          + ", ".join(split) + " s)")
    timed = per_step[1:1 + TRAIN_TIMED]
    window.update(cfg=cfg, shape=shape, steps=TRAIN_TIMED, launches={
        "flash_attention": sum(st[0]["wgmma_bf16"] for st in timed),
        "ssd_intra": sum(st[1]["wgmma_bf16"] for st in timed),
        "ssd_intra_bwd": sum(st[2] for st in timed)})
    # a timed step's launches, as counted (every step's equal `want`)
    return {"flash_attention": per_step[1][0]["wgmma_bf16"],
            "ssd_intra": per_step[1][1]["wgmma_bf16"],
            "ssd_intra_bwd": per_step[1][2]}, \
        {"step_s": s, "peak": peak - others}, window


def granite_step_check(torch, dev, card: str) -> None:
    """Phase 12 (d): one granite-3-2b train step at full width (bf16, B 1,
    S 512), the main path of its benchmark cell: the attention backward
    called once a layer, every call on the kernel route (three launches
    each), and a finite loss."""
    from repro_torch.configs import ShapeSpec, get_config, make_inputs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grad
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    cfg = get_config("granite-3-2b")
    params = init_params(cfg, device=dev)
    state = adamw.init(adamw.OptConfig(), params)
    step = steps.make_train_step(cfg, adamw.OptConfig())
    batch = make_inputs(cfg, ShapeSpec("train", 512, 1, "train"), device=dev)
    routes = grad.flash_bwd_routes()
    launches = fa.flash_attention_bwd_kernel.launches
    t0 = time.perf_counter()
    _, _, aux = step(params, state, batch)
    loss = float(aux["loss"])
    s = time.perf_counter() - t0
    now = grad.flash_bwd_routes()
    calls = {r: now[r] - routes[r] for r in now}
    n = fa.flash_attention_bwd_kernel.launches - launches
    check(calls == {"kernel": cfg.num_layers, "plain": 0}
          and n == 3 * cfg.num_layers,
          f"{cfg.name}'s train step: attention backward calls {calls} and "
          f"{n} kernel launches, expected {cfg.num_layers} on the kernel "
          f"route and {3 * cfg.num_layers} launches")
    check(math.isfinite(loss), f"{cfg.name}'s train step: loss {loss}")
    print(f"train: {cfg.name} at full width, B 1, S 512, bf16: one step "
          f"(its first, with the warm-up) {s:.3f} s, loss {loss:.4f}; "
          f"attention backward {calls['kernel']} calls on the kernel route "
          f"and {calls['plain']} plain, {n} kernel launches [{card}]")
    del params, state, step, batch, aux
    torch.cuda.empty_cache()


def train_family_check(torch, dev, model: str, S: int) -> None:
    """A family at published width and 2 layers, f32: one train step on
    the card against the same step on the CPU (loss, grad norm, every
    gradient leaf by `grads_close`, with exact launch counts; the limit
    must reject an all-zero gradient and the card's step under one of
    `grad_mutants`), then a crash after a checkpoint, a restore and a
    resume through `Trainer`, whose last loss must equal an uninterrupted
    run's."""
    import contextlib
    import dataclasses
    import tempfile

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import synthetic_batch, to_device
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.train.trainer import TrainConfig, Trainer
    t0 = time.perf_counter()
    fa, sk = flash_attention_kernel, ssd_intra_kernel
    cfg = get_config(model)
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                              encoder_layers=min(cfg.encoder_layers, 2))
    shape = ShapeSpec("t", S, 1, "train")
    # phase 12's optimizer options: the checkpoints stay small (llama's
    # f32 moments alone would be 4.8 GB a checkpoint)
    opt = adamw.OptConfig(**TRAIN_OPT)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(6),
                         device=dev)
    batch = synthetic_batch(cfg, shape, 0, seed=6)
    # the copies first: the card's step updates its parameters in place
    trees = {"cpu": tree_map(lambda t: t.to("cpu", copy=True), params),
             "mutant": tree_map(lambda t: t.clone(), params),
             "card": params}
    mutant = "d-dacs-dropped" if cfg.ssm_state else "dq-zeroed"
    runs = {}
    for where in ("mutant", "card", "cpu"):
        d = torch.device("cpu") if where == "cpu" else dev
        p = trees.pop(where)
        step = make_train_step(cfg, opt)
        zero_counts(fa, sk)
        with (grad_mutants(torch)[mutant] if where == "mutant"
              else contextlib.nullcontext()):
            _, _, m = step(p, adamw.init(opt, p), to_device(cfg, batch, d))
        runs[where] = ({k: float(v) for k, v in m.items()}, step.grads,
                       (dict(fa.launches_by), dict(sk.launches_by)))
    del params, p
    (mc, gc, lc), (mu, gu, _) = runs["card"], runs["cpu"]
    gm = runs["mutant"][1]
    want = {"llama3.2-3b": (4, 0), "mamba2-780m": (0, 4),
            "whisper-small": (12, 0)}[model]
    check(lc == ({"wgmma_bf16": 0, "simt": want[0]},
                 {"wgmma_bf16": 0, "simt": want[1]}),
          f"{model}: a train step launched {lc}, expected {want[0]} flash "
          f"and {want[1]} SSD on simt (f32; forward and recompute)")
    for k in mu:
        check(abs(mc[k] - mu[k]) <= 1e-4 * abs(mu[k]),
              f"{model}: {k} {mc[k]} on the card, {mu[k]} on the CPU")
    grads_close(torch, f"{model} (2 layers) train step gradients, card vs "
                "CPU, f32", gc, gu,
                {"zeroed": tree_map(torch.zeros_like, gu), mutant: gm})
    del runs, gc, gu, gm

    def trainer(ck, total, every, hook=None):
        return Trainer(cfg, shape, opt,
                       TrainConfig(total_steps=total, ckpt_every=every,
                                   ckpt_dir=ck, keep=1, seed=7, log_every=1,
                                   monitor=False, device=str(dev)),
                       fault_hook=hook)

    def crash(step):
        if step == 2:
            raise RuntimeError("injected failure")
    with tempfile.TemporaryDirectory() as ck:
        full = trainer(ck + "/a", 3, 0).run()
        try:
            trainer(ck + "/b", 3, 2, crash).run()
            fail(f"{model}: the injected failure did not stop the run")
        except RuntimeError as e:
            check("injected" in str(e), f"{model}: {e}")
        resumed = trainer(ck + "/b", 3, 2).run()
    a, b = full["final_loss"], resumed["final_loss"]
    check(resumed["final_step"] == 3
          and [m["step"] for m in resumed["metrics"]] == [3]
          and abs(a - b) <= 1e-3 * abs(a),
          f"{model}: the resumed run's last loss {b} (steps "
          f"{[m['step'] for m in resumed['metrics']]}), uninterrupted {a}")
    print(f"train family {model}: loss {mc['loss']:.6f} card, "
          f"{mu['loss']:.6f} CPU; grad norm {mc['grad_norm']:.6f}, "
          f"{mu['grad_norm']:.6f}; launches flash {want[0]}, SSD {want[1]} "
          f"simt; crash at step 2 after a checkpoint, resumed: last loss "
          f"{b:.6f} vs uninterrupted {a:.6f} (|diff| {abs(a - b):.3e}); "
          f"{time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# 13. the paper's benchmark suite and examples on the card
# ---------------------------------------------------------------------------
#: the benchmark modules whose rows are host NumPy: each row's name and
#: derived field must equal the port's own CPU run's (Fig. 1's closed
#: form, Fig. 3, Table I, Table II)
HOST_BENCH = ("tile_quantization", "precision_scaling", "clock_sampling",
              "prediction_accuracy")
#: Fig. 1's sweep driven through the GEMM kernel: its aligned sizes and
#: the first random shapes of its rng with every side >= 4,096, in each
#: precision
SWEEP_N, SWEEP_RANDOM = (4096, 8192, 16384), 3
SWEEP_KINDS = ("bf16", "int8", "fp32")
#: the quickstart example on the card: its arch, --steps, and the
#: re-run's --steps, which must resume from the first run's checkpoint
QUICKSTART = ("zamba2-7b", 10, 15)


@contextlib.contextmanager
def quiet(path: Path):
    """Send a phase's own prints (the benchmark CSV, the examples'
    walkthroughs) to `path` instead of this script's output."""
    with path.open("a") as f, contextlib.redirect_stdout(f):
        yield


def bench_phase(torch, dev, card: str) -> dict:
    """13. The paper's benchmark suite (`repro_torch.benchmarks.run`'s
    seven modules, on the card at the reference's own sizes), Fig. 1's
    sweep through the GEMM kernel at the sweep's sizes, and the three
    examples on the card.  Returns the launches of the histogram and GEMM
    kernels over the suite's run."""
    import importlib
    import os
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.kernels import fleet_hist as fh
    from repro_torch.kernels import gemm

    t_phase = time.perf_counter()
    out = Path(__file__).resolve().parent / "build" / "bench"
    out.mkdir(parents=True, exist_ok=True)
    log = out / "bench.log"
    log.unlink(missing_ok=True)
    os.environ["BENCH_FLEET_JSON"] = str(out / "BENCH_fleet.json")
    Path(os.environ["BENCH_FLEET_JSON"]).unlink(missing_ok=True)

    fh.ofu_bucket_hist.launches = 0
    zero_counts(gemm.gemm_padded)
    torch.cuda.synchronize()
    try:
        with quiet(log):
            results = bench_run.main([])
    except SystemExit as e:
        errors = [ln for ln in log.read_text().splitlines() if ",ERROR:" in ln]
        fail(f"benchmark suite: {e}: {errors}")
    torch.cuda.synchronize()
    launches = {"fleet_hist": fh.ofu_bucket_hist.launches,
                "gemm": gemm.gemm_padded.launches}
    names = [m.__name__.split(".")[-1] for m in bench_run.modules()]
    check(sorted(results) == sorted(names),
          f"benchmark suite ran {sorted(results)}, expected {names}")
    print(f"bench suite: launches {launches} (B2 by variant "
          f"{dict(gemm.gemm_padded.launches_by)}); wall s " + ", ".join(
              f"{n} {results[n][1]:.2f}" for n in names)
          + f"; {card}")
    check(launches["fleet_hist"] >= 608 and launches["gemm"] >= 3,
          f"the suite launched the histogram kernel "
          f"{launches['fleet_hist']} times (>= 608) and the GEMM "
          f"{launches['gemm']} (>= 3)")
    rows = {r.name: r for rs, _ in results.values() for r in rs}

    # the host NumPy rows against the port's own run of them on the CPU
    t0 = time.perf_counter()
    cpu = []
    for name in HOST_BENCH:
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        kw = {"verify_kernel": False} if name == "tile_quantization" else {}
        cpu += mod.run(device="cpu", **kw)
    for r in cpu:
        got = rows.get(r.name)
        check(got is not None and got.derived == r.derived,
              f"{r.name}: the card run's row {got} differs from the CPU "
              f"run's {r}")
    kernel_row = rows["fig1.kernel_grid_vs_closed_form"].derived
    check(kernel_row == "exact_match_on=3 shapes (0 FLOP error)",
          f"fig1.kernel_grid_vs_closed_form: {kernel_row}")
    print(f"bench host rows: {len(cpu)} rows of {', '.join(HOST_BENCH)} "
          f"equal to the CPU run's ({time.perf_counter() - t0:.2f} s); "
          f"fig1.kernel_grid_vs_closed_form: {kernel_row}")
    for name in ("fig5.correlation", "correlation.miscalc_scan"):
        kv = dict(f.split("=", 1) for f in rows[name].derived.split())
        check(kv["exact_match"] == "True" and kv["flagged"] == "82"
              and float(kv["r_after_exclusion"]) >= 0.75,
              f"{name}: {rows[name].derived}")
        print(f"bench {name}: {rows[name].derived}")
    with open(os.environ["BENCH_FLEET_JSON"]) as f:
        cases = {c["name"]: c for c in json.load(f)["cases"]}
    ft = cases["fleet_engine_torch"]["metrics"]
    check(ft["route"] == "cuda" and ft["kernel_counts_equal_plain"],
          f"fleet_engine_torch: {ft}")
    print(f"bench fleet_engine_torch: {ft['devices']} devices x "
          f"{ft['hours']} h, engine {ft['torch_wall_s']} s on the card "
          f"({ft['cpu_wall_s']} s on the host CPU), ingest samples/s kernel "
          f"{ft['ingest_kernel_samples_per_s']}, plain "
          f"{ft['ingest_plain_samples_per_s']}, host NumPy "
          f"{ft['ingest_numpy_samples_per_s']}; kernel counts == plain "
          "counts bitwise")
    for name in ("fleet_engine.vector_1000dev_1h_rollup",
                 "fleet_engine.perjob_600job_sweep",
                 "fleet_engine.fused_600job_sweep",
                 "fleet_engine.collector_round_64job",
                 "fleet_engine.ingest_submit_10000host",
                 "fig6.embodied_agent_regression",
                 "fig7.mixed_precision_6144"):
        print(f"bench {rows[name].csv()}")

    gemm_sweep(torch, dev, card)
    examples_phase(torch, dev, card, out)
    print(f"bench phase 13: {time.perf_counter() - t_phase:.2f} s ({card})")
    return launches


def sweep_shapes() -> list:
    """Fig. 1's sweep sizes: N x N x N at `SWEEP_N`, then the sweep's
    first `SWEEP_RANDOM` random shapes with every side >= 4,096."""
    rng = np.random.default_rng(0)      # tile_quantization.run's stream:
    for _ in range(300):                # past its first band, the bf16
        rng.integers(256, 12288, 3)     # random shapes of any size
    return [(n, n, n) for n in SWEEP_N] + [
        tuple(int(v) for v in rng.integers(4096, 12288, 3))
        for _ in range(SWEEP_RANDOM)]


def gemm_sweep(torch, dev, card: str, chip=None) -> None:
    """Fig. 1's sweep through the GEMM kernel at the sweep's own sizes in
    bf16, int8 and fp32, under `chip`'s tile policies (`pick_policy`;
    None: the simulated fleet's MXU blocks): each call's launched FLOPs
    must equal its GemmProfile's and the closed form; 64 random rows of
    each output are held against a float64 product of the same operands
    (bf16 to 2^-6 of the value plus 2^-5 of the row's RMS, fp32 as
    `gemm_path`, int8 exact); the kernel alone is timed on the padded
    operands, beside the policy's predicted tile waste."""
    from repro_torch.core.tile_quant import pick_policy, profiled_flops
    from repro_torch.kernels import gemm, ops

    shapes = sweep_shapes()
    tiles = f"{chip.name} tiles" if chip is not None else "MXU tiles"
    gen = torch.Generator(device=dev).manual_seed(13)
    zero_counts(gemm.gemm_padded)
    gemm.gemm_padded.launched_flops = 0
    t0 = time.perf_counter()
    for M, N, K in shapes:
        for kind in SWEEP_KINDS:
            x, y = gemm_inputs(torch, gen, dev, M, N, K, kind)
            f0 = gemm.gemm_padded.launched_flops
            c, prof = ops.matmul(x, y, chip=chip)
            launched = gemm.gemm_padded.launched_flops - f0
            closed = profiled_flops(M, N, K,
                                    pick_policy(M, N, K, kind, chip))
            check(launched == prof.profiled_flops == closed,
                  f"sweep ({M}, {N}, {K}) {kind}: launched {launched}, "
                  f"profiled {prof.profiled_flops}, closed form {closed}")
            pick = torch.randperm(M, generator=gen, device=dev)[:64]
            want = x[pick].double() @ y.double()
            got = c[pick].double()
            if kind == "int8":
                err = (got - want).abs().max().item()
                ok = err == 0
            else:
                rtol, atol = ((BF16_RTOL, BF16_ROW_ATOL) if kind == "bf16"
                              else (1e-3, 1e-4 * K / 128))
                rms = want.pow(2).mean(dim=1, keepdim=True).sqrt()
                lim = rtol * want.abs() + (atol * rms if kind == "bf16"
                                           else atol)
                err = ((got - want).abs() / lim).max().item()
                ok = err <= 1
            check(ok, f"sweep ({M}, {N}, {K}) {kind}: output off by "
                  f"{err} of the limit")
            pol = prof.policy
            xp = ops._pad_to(x, pol.tm * pol.cm, pol.tk).contiguous()
            yp = ops._pad_to(y, pol.tk, pol.tn * pol.cn).contiguous()
            ms = event_ms(torch, lambda: gemm.gemm_padded(xp, yp, pol), REPS)
            peak = PEAK_OPS_PER_S[kind] / 1e12
            print(f"sweep ({M}, {N}, {K}) {kind}, {tiles}: policy "
                  f"{pol.name}, "
                  f"{launched:,d} FLOPs launched == profiled == closed form "
                  f"(overhead {prof.overhead:.2%}); kernel {ms:.4f} ms, "
                  f"{launched / ms / 1e9:.1f} TFLOP/s executed "
                  f"({launched / ms / 1e9 / peak:.1%} of {peak:g}), "
                  f"{prof.theoretical_flops / ms / 1e9:.1f} useful; "
                  f"64 rows {'max |diff| ' if kind == 'int8' else ''}"
                  f"{err:.3g}{'' if kind == 'int8' else ' of the limit'}")
            del x, y, c, xp, yp, want, got
    by = dict(gemm.gemm_padded.launches_by)
    per = 2 + REPS                      # checked call, warm-up, timed
    want_by = {"wgmma_bf16": per * len(shapes), "wgmma_s8": per * len(shapes),
               "simt": per * len(shapes)}
    check(by == want_by, f"sweep launches by variant {by}, expected "
          f"{want_by}")
    print(f"sweep ({tiles}): {len(shapes)} shapes x {len(SWEEP_KINDS)} "
          f"precisions, launches by variant {by}; "
          f"{time.perf_counter() - t0:.2f} s ({card})")


def examples_phase(torch, dev, card: str, out: Path) -> None:
    """The three examples on the card.  quickstart trains zamba2-7b's
    smoke config (hd 16: both model kernels on their SIMT variants) into a
    temporary checkpoint directory with exact flash and SSD launch counts
    (2 a forward group and layer: the forward and remat's recompute) and
    finite losses, then a re-run with more steps must resume from its
    checkpoint; fleet_monitoring must flag the jobs it flags on the CPU;
    mixed_precision_pretrain's OFU must track the MFU shift on both."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.examples import (fleet_monitoring,
                                      mixed_precision_pretrain, quickstart)
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.kernels import fleet_hist as fh
    from repro_torch.models.ssm_models import _groups

    fa, ssd = flash_attention.flash_attention_kernel, ssd_scan.ssd_intra_kernel
    arch, steps, rerun = QUICKSTART
    cfg = get_config(arch).smoke()
    log = out / "examples.log"
    log.unlink(missing_ok=True)
    with tempfile.TemporaryDirectory() as ck:
        for first, last in ((0, steps), (steps, rerun)):
            zero_counts(fa, ssd)
            t0 = time.perf_counter()
            with quiet(log):
                res = quickstart.main(["--arch", arch, "--steps", str(last),
                                       "--ckpt-dir", ck])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = last - first
            want = ({"wgmma_bf16": 0, "simt": 2 * n * len(_groups(cfg))},
                    {"wgmma_bf16": 0, "simt": 2 * n * cfg.num_layers})
            got = (dict(fa.launches_by), dict(ssd.launches_by))
            logged = [m["step"] for m in res["metrics"]]
            losses = [m["loss"] for m in res["metrics"]]
            check(res["final_step"] == last
                  and logged == list(range(first + 5, last + 1, 5))
                  and all(math.isfinite(v) for v in losses),
                  f"quickstart --steps {last}: final step "
                  f"{res['final_step']}, logged steps {logged}, losses "
                  f"{losses}")
            check(got == want, f"quickstart --steps {last}: launches flash "
                  f"{got[0]}, SSD {got[1]}, expected {want}")
            times = [round(m["step_time_s"], 4) for m in res["metrics"]]
            print(f"quickstart --arch {arch} --steps {last}"
                  f"{' (resumed from step %d)' % first if first else ''}: "
                  f"{n} steps in {wall:.2f} s, losses {losses}, logged step "
                  f"times {times} s; launches flash {got[0]}, SSD {got[1]} "
                  f"({card})")

    t0 = time.perf_counter()
    fh.ofu_bucket_hist.launches = 0
    with quiet(log):
        on_card = fleet_monitoring.main([])
        torch.cuda.synchronize()
        b1 = fh.ofu_bucket_hist.launches
        on_cpu = fleet_monitoring.main(["--device", "cpu"])
    check(on_card["flagged"] and on_card["flagged"] == on_cpu["flagged"],
          f"fleet_monitoring flagged {on_card['flagged']} on the card, "
          f"{on_cpu['flagged']} on the CPU")
    check(b1 >= 1, "fleet_monitoring never launched the histogram kernel")
    print(f"fleet_monitoring: flagged {on_card['flagged']} on the card and "
          f"the CPU; collector alerts on {on_card['collector_alerted']} "
          f"(CPU {on_cpu['collector_alerted']}), served alerts "
          f"{on_card['served_alerts']} (CPU {on_cpu['served_alerts']}); "
          f"histogram kernel {b1} launches; {time.perf_counter() - t0:.2f} "
          "s for both")
    with quiet(log):
        r_card = mixed_precision_pretrain.main([])
        r_cpu = mixed_precision_pretrain.main(["--device", "cpu"])
    check(r_card > 0.9 and r_cpu > 0.9, f"mixed_precision_pretrain: "
          f"pointwise r {r_card} on the card, {r_cpu} on the CPU")
    print(f"mixed_precision_pretrain: pointwise r {r_card:.4f} on the card, "
          f"{r_cpu:.4f} on the CPU")



# ---------------------------------------------------------------------------
# 14. the kernels as ops, the dry run, its roofline, and the six CLIs
# ---------------------------------------------------------------------------
#: the dry run's peak memory must lie within this share of the card's
#: measured peak, for phase 11's prefill and phase 12's train step
DRYRUN_PEAK_TOL = 0.15
#: the fleet tools, each run as `main(["--self-check"])` on the card
TOOLS = ("trace_convert", "fleet_serve", "fleet_ingest", "fleet_live",
         "fleet_correlate", "fleet_scorecard")
#: calls timed for the ops' host overhead
OP_CALLS = 200


def dryrun_phase(torch, dev, card: str, measured: dict,
                 mesh_cells: dict) -> dict:
    """14. (a) B3 and B4 through their ops against their direct launch;
    (b) the dry run of the three steps phases 11 and 12 ran, against what
    the card measured; (c) its roofline against the H100 SXM data sheet
    and the measured times; (d) the six CLIs' self-checks on the card;
    (b') the dry run on the production mesh; (e) a one-rank process group
    on the card.  Returns the histogram kernel's launches by CLI."""
    t_phase = time.perf_counter()
    ops_check(torch, dev)
    marks = {"ops": time.perf_counter()}
    recs = dryrun_check(torch, card, measured)
    marks["dry run"] = time.perf_counter()
    roofline_check(recs, card, measured)
    launches = tools_check(torch, card)
    marks["tools"] = time.perf_counter()
    mesh_dryrun_check(torch, card, mesh_cells)
    marks["mesh dry run"] = time.perf_counter()
    one_rank_check(torch, dev, card)
    marks["one rank"] = time.perf_counter()
    split, t = [], t_phase
    for name, mark in marks.items():
        split.append(f"{name} {mark - t:.2f}")
        t = mark
    print(f"dry-run phase 14: {time.perf_counter() - t_phase:.2f} s ("
          + ", ".join(split) + f" s) [{card}]")
    return launches


#: the production mesh's cells, each traced in its own process beside the
#: card's phases (`--mesh-cell`), and the limit on their wait in phase 14
MESH_ARCHS = ("zamba2-7b", "nemotron-4-340b")
MESH_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESH_WAIT_S = 900
#: each cell's per-device peak bytes, collective wire bytes and FLOPs as
#: the CPU traces them (`python -m repro_torch.launch.dryrun --arch A
#: --shape S`, PyTorch 2.13 built for the CPU): the card's trace, on its
#: own PyTorch, must agree within MESH_AGREE (a relative limit), or the
#: placements DTensor chose there differ from the ones the tests hold
MESH_CPU = {
    ("zamba2-7b", "train_4k"): (1639616000, 243061199670.0, 302402672263168.0),
    ("zamba2-7b", "prefill_32k"): (1757031424, 57688919040.0, 91897568559104.0),
    ("zamba2-7b", "decode_32k"): (4692163072, 92968620.0, 12669408256.0),
    ("nemotron-4-340b", "train_4k"): (33380686848, 1944075901470.0, 1.0331938967519232e+16),
    ("nemotron-4-340b", "prefill_32k"): (11573940224, 540660917760.0, 3231842631155712.0),
    ("nemotron-4-340b", "decode_32k"): (14097863680, 1732392960.0, 452267606016.0),
}
MESH_AGREE = 0.01
#: phase 14 (e): zamba2-7b at full width, this many layers
ONE_RANK_LAYERS, ONE_RANK_S = 6, 4096


def mesh_cell_main(arch: str, shape: str, out: str) -> None:
    """`--mesh-cell ARCH SHAPE OUT`: one production-mesh cell's dry-run
    record, with the flash and SSD kernels' launches in this process,
    written to OUT as JSON."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    rec = run_cell(arch, shape)
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = {"flash_attention": flash_attention_kernel.launches,
                       "ssd_intra": ssd_intra_kernel.launches}
    Path(out).write_text(json.dumps(rec))


def start_mesh_cells() -> dict:
    """Start one `--mesh-cell` process a production-mesh cell (a fake
    trace: host work only, at low priority), to be read in phase 14.
    Returns {(arch, shape): (process, record path)}; every process is
    killed at exit if still running."""
    import atexit
    import os
    out = Path(__file__).resolve().parent / "build" / "dryrun_mesh"
    out.mkdir(parents=True, exist_ok=True)
    cells = {}
    for arch in MESH_ARCHS:
        for shape in MESH_SHAPES:
            path = out / f"{arch}_{shape}_single.json"
            path.unlink(missing_ok=True)
            log = open(out / f"{arch}_{shape}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--mesh-cell", arch, shape, str(path)],
                stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(10))
            cells[arch, shape] = (proc, path)

    def stop():
        for proc, _ in cells.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop)
    return cells


def spec_bytes(arch: str, shape_name: str, layout: dict) -> int:
    """One device's bytes of a cell's arguments (parameters, optimizer
    state, batch) from their shapes and the layout's specs alone."""
    import torch
    from repro_torch.configs import SHAPES, get_config, input_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import (batch_shardings,
                                             opt_state_shardings,
                                             param_shardings, shard_bytes)
    from repro_torch.models import abstract_params
    from repro_torch.optim import adamw
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = make_production_mesh()
    dp, tp, fsdp = tuple(layout["dp"]), layout["tp"], layout["fsdp"]
    params = abstract_params(cfg)
    with torch.device("meta"):
        batch = {k: torch.empty(s.shape, dtype=s.dtype)
                 for k, s in input_specs(cfg, shape).items()}
    n = shard_bytes(params, param_shardings(
        cfg, params, mesh, dp, tp, fsdp, serving=layout["serving"]), mesh)
    n += shard_bytes(batch, batch_shardings(cfg, shape, mesh, dp, tp), mesh)
    if shape.kind == "train":
        opt = layout["opt"]
        state = adamw.init(adamw.OptConfig(
            moment_dtype=opt.split("/")[0],
            factored_v=opt.endswith("factored_v")), params)
        n += shard_bytes(state, opt_state_shardings(state, mesh, dp, tp,
                                                    fsdp), mesh)
    return n


def mesh_dryrun_check(torch, card: str, cells: dict) -> None:
    """(b') The production-mesh cells' records: per-device bytes, FLOPs,
    collectives and roofline terms, printed; argument bytes equal to the
    specs' shard sum, nonzero collectives, no kernel launched."""
    from repro_torch.benchmarks.roofline import roofline_terms
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    before = (flash_attention_kernel.launches, ssd_intra_kernel.launches)
    deadline = time.perf_counter() + MESH_WAIT_S
    for (arch, shape), (proc, path) in cells.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"mesh dry run {arch} {shape}: not done in {MESH_WAIT_S} s")
        log = path.parent / f"{arch}_{shape}.log"
        check(rc == 0 and path.exists(), f"mesh dry run {arch} {shape} "
              f"failed (rc {rc}); the end of {log}:\n"
              + "\n".join(log.read_text().splitlines()[-25:]))
        rec = json.loads(path.read_text())
        check((rec["mesh"], rec["devices"]) == ("16x16", 256),
              f"mesh dry run {arch} {shape}: on {rec['mesh']}")
        check(rec["launches"] == {"flash_attention": 0, "ssd_intra": 0},
              f"mesh dry run {arch} {shape} launched {rec['launches']}")
        mem, hlo = rec["memory"], rec["hlo"]
        want = spec_bytes(arch, shape, rec["parallelism"])
        check(mem["argument_bytes"] == want, f"mesh dry run {arch} {shape}: "
              f"argument bytes {mem['argument_bytes']} != the specs' shard "
              f"sum {want}")
        coll = {k: v for k, v in hlo["collective_bytes"].items() if v}
        check(coll, f"mesh dry run {arch} {shape}: no collective bytes")
        got = (mem["peak_bytes"], sum(coll.values()), hlo["flops"])
        cpu = MESH_CPU[arch, shape]
        for name, a, b in zip(("peak", "wire", "FLOPs"), got, cpu):
            check(abs(a - b) <= MESH_AGREE * b, f"mesh dry run {arch} "
                  f"{shape}: the card traces {name} {a:.6e}, the CPU "
                  f"{b:.6e} (more than {MESH_AGREE:.0%} apart); live at "
                  f"the peak: {mem['at_peak'][:4]}")
        t = roofline_terms(rec)
        fits = "fits" if mem["peak_bytes"] <= 80e9 else "does NOT fit"
        print(f"mesh dry run {arch} {shape} on 16x16, per device (counts "
              f"from a fake trace, {rec['wall_s']:.1f} s): arguments "
              f"{mem['argument_bytes'] / 2**30:.3f} GiB (= the specs' "
              f"shard sum), peak {mem['peak_bytes'] / 2**30:.3f} GiB "
              f"(temporaries {mem['temp_bytes'] / 2**30:.3f}; {fits} 80 "
              f"GB); FLOPs {hlo['flops']:.4e}; collectives " + ", ".join(
                  f"{k} {v / 2**30:.3f} GiB x{hlo['collective_counts'][k]:.0f}"
                  for k, v in coll.items())
              + f"; roofline compute {t['compute_s']:.4f} s, memory "
              f"{t['memory_s']:.4f} s, collective {t['collective_s']:.4f} s; "
              f"peak, wire and FLOPs within {MESH_AGREE:.0%} of the CPU's "
              f"trace [{card}]")
    check((flash_attention_kernel.launches, ssd_intra_kernel.launches)
          == before, "the mesh dry run moved the kernels' launch counts")


def one_rank_check(torch, dev, card: str) -> None:
    """(e) A one-rank `nccl` group and a (1, 1) mesh: zamba2-7b's prefill
    with DTensor parameters against the unsharded port, bitwise, with
    the kernels' launch counts equal."""
    import dataclasses
    import os
    import torch.distributed as dist
    from repro_torch.configs import ShapeSpec, get_config, make_inputs
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.sharding import (batch_shardings,
                                             distribute_tree,
                                             param_shardings)
    from repro_torch.models import api as models
    from repro_torch.models.common import ShardCtx
    store = Path(__file__).resolve().parent / "build" / "pg" / "store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    check(not dist.is_initialized(), "a process group is already open")
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        cfg = dataclasses.replace(get_config(SERVE_MODEL),
                                  num_layers=ONE_RANK_LAYERS)
        shape = ShapeSpec("prefill", ONE_RANK_S, 1, "prefill")
        params = models.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        batch = make_inputs(cfg, shape, device=dev)
        mesh = make_smoke_mesh(1, device_type="cuda")
        dp, tp = ("data",), "model"
        ctx = ShardCtx(mesh, dp, tp)
        dparams = distribute_tree(params, param_shardings(
            cfg, params, mesh, dp, tp), mesh)
        dbatch = distribute_tree(batch, batch_shardings(
            cfg, shape, mesh, dp, tp), mesh)
        counts = {}
        outs = {}
        for name, args in (("plain", (params, batch, None)),
                           ("mesh", (dparams, dbatch, ctx))):
            zero_counts(flash_attention_kernel, ssd_intra_kernel)
            with torch.no_grad():
                out = models.forward(cfg, *args)
            torch.cuda.synchronize()
            counts[name] = (flash_attention_kernel.launches,
                            ssd_intra_kernel.launches)
            outs[name] = out.full_tensor() if name == "mesh" else out
        check(counts["plain"] == counts["mesh"] and min(counts["plain"]) > 0,
              f"one-rank mesh: launches {counts['mesh']} vs unsharded "
              f"{counts['plain']}")
        check(torch.equal(outs["plain"], outs["mesh"]),
              "one-rank mesh: the logits differ from the unsharded port's")
        print(f"one-rank nccl mesh (1, 1): {SERVE_MODEL} at full width, "
              f"{ONE_RANK_LAYERS} layers, prefill S {ONE_RANK_S}: logits "
              f"{tuple(outs['mesh'].shape)} bitwise equal to the unsharded "
              f"port's; flash/SSD launches {counts['mesh']} through their "
              f"sharding rules, as unsharded [{card}]")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the one-rank group is still open")


def host_us(torch, fn, n: int) -> float:
    """Host microseconds a call of fn over n calls, synchronised after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def ops_check(torch, dev) -> None:
    """(a) zamba2-7b's flash and SSD calls (phase 10's shapes) through the
    ops `repro_torch::flash_attention` and `repro_torch::ssd_intra`:
    bitwise the kernels' direct launch on the same inputs; each op's
    host time a call beside the direct launch's and the kernel's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd_scan
    cfg = get_config(SERVE_MODEL)
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    B, S, H, KV, hd = 1, PREFILL_S, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(bf)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=dev).to(bf)
            for _ in range(2))
    scale = hd ** -0.5
    nh, shd, g, ds = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                      cfg.ssm_state)
    x = (torch.randn((B, S, nh, shd), generator=gen, device=dev) * 0.5).to(bf)
    dt = torch.empty((B, S, nh), device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen).exp_()
    A = -torch.empty(nh, device=dev).uniform_(1.0, 16.0, generator=gen)
    Bm, Cm = ((torch.randn((B, S, g, ds), generator=gen, device=dev) * 0.3)
              .to(bf) for _ in range(2))
    inputs = ops.ssd_intra_inputs(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    Q = inputs[0].shape[1]
    calls = {
        "flash_attention": (
            lambda: torch.ops.repro_torch.flash_attention(
                q, k, v, True, scale, fa.variant(bf, hd)),
            lambda: fa._launch(q, k, v, True, scale)),
        "ssd_intra": (
            lambda: torch.ops.repro_torch.ssd_intra(
                *inputs, ssd_scan.variant(bf, Q, shd, ds))[0],
            lambda: ssd_scan._launch(*inputs)),
    }
    for name, (op, direct) in calls.items():
        got, want = op(), direct()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name}: the op's output differs "
              "from the direct launch's on the same inputs")
        op_us, direct_us = host_us(torch, op, OP_CALLS), \
            host_us(torch, direct, OP_CALLS)
        ms = event_ms(torch, direct, REPS)
        print(f"ops {name} at {SERVE_MODEL} width {tuple(got.shape)}: "
              f"bitwise equal to the direct launch; host {op_us:.1f} us a "
              f"call through the op, {direct_us:.1f} us direct (op "
              f"overhead {op_us - direct_us:.1f} us), kernel "
              f"{ms:.4f} ms")


class _NeverFrees:
    """Mutant tracker: a storage's bytes stay live after it dies."""

    def _free(self, key, n, _ref):
        self._refs.pop(key, None)


class _ArgumentsOnly:
    """Mutant tracker: counts the arguments and nothing an op allocates."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def dryrun_check(torch, card: str, measured: dict) -> dict:
    """(b) The dry run (`launch.dryrun.run_cell`, fake CUDA tensors) of
    zamba2-7b's prefill, decode loop step and train step as phases 11 and
    12 ran them: FLOPs beside `step_flops`, peak beside the card's
    measured peak; prefill and train within DRYRUN_PEAK_TOL, a limit that
    must reject a tracker that never frees and one that counts only the
    arguments.  Returns the records by tag."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.flops.accounting import step_flops
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_intra_kernel
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.hlo_analysis import LiveBytes
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import adamw
    cfg = get_config(SERVE_MODEL)
    mutant_types = {"never-frees": _NeverFrees,
                    "arguments-only": _ArgumentsOnly}
    cells = {
        "prefill": (ShapeSpec("prefill", PREFILL_S, 1, "prefill"), {},
                    measured["prefill_peak"]),
        "decode": (ShapeSpec("decode", DECODE_CTX, DECODE_B, "decode"), {},
                   measured["decode_peak"]),
        "train": (ShapeSpec("train", TRAIN_S, 1, "train"),
                  {"opt_cfg": adamw.OptConfig(**TRAIN_OPT),
                   "accum_steps": 1}, measured["train_peak"])}
    recs, off = {}, {name: [] for name in mutant_types}
    zero_counts(flash_attention_kernel, ssd_intra_kernel)
    for name, (shape, kw, peak) in cells.items():
        mutants = {m: type(m, (t, LiveBytes), {})()
                   for m, t in mutant_types.items()}
        t0 = time.perf_counter()
        rec = run_cell(SERVE_MODEL, shape, device="cuda",
                       trackers=tuple(mutants.values()),
                       mesh=make_smoke_mesh(1), **kw)
        trace_s = time.perf_counter() - t0
        check(rec["trace_device"] == "cuda", f"dry run traced on "
              f"{rec['trace_device']}")
        recs[f"{SERVE_MODEL}_{name}_single"] = rec
        flops = rec["hlo"]["flops"]
        want = step_flops(cfg, shape, executed=True,
                          remat=cfg.remat != "none").total_mxu
        dry = rec["memory"]["peak_bytes"]
        err = dry / peak - 1
        errs = {m: t.peak / peak - 1 for m, t in mutants.items()}
        print(f"dry run {name}: {SERVE_MODEL} {shape}: traced in "
              f"{trace_s:.2f} s; FLOPs {flops:.4e} (count), step_flops "
              f"{want:.4e}, ratio {flops / want:.4f}; peak {dry / 2**30:.3f} "
              f"GiB (arguments {rec['memory']['argument_bytes'] / 2**30:.3f}"
              f", temporaries {rec['memory']['temp_bytes'] / 2**30:.3f}) vs "
              f"measured {peak / 2**30:.3f} GiB [{card}]: {err:+.2%}; "
              "mutant trackers " + ", ".join(
                  f"{m} {t.peak / 2**30:.3f} GiB ({errs[m]:+.2%})"
                  for m, t in mutants.items()))
        if name != "decode":
            check(abs(err) <= DRYRUN_PEAK_TOL,
                  f"dry run {name}: peak {dry} is {err:+.2%} from the "
                  f"measured {peak}, past {DRYRUN_PEAK_TOL:.0%}")
            for m, e in errs.items():
                if abs(e) > DRYRUN_PEAK_TOL:
                    off[m].append(name)
    check(flash_attention_kernel.launches == 0
          and ssd_intra_kernel.launches == 0,
          "the fake trace raised the kernels' launch counts")
    for m, names in off.items():
        check(names, f"the {DRYRUN_PEAK_TOL:.0%} limit does not reject "
              f"the {m} tracker on the prefill or the train step")
        print(f"dry run: the {DRYRUN_PEAK_TOL:.0%} limit rejects the {m} "
              f"tracker on: {', '.join(names)}")
    return recs


def roofline_check(recs: dict, card: str, measured: dict) -> None:
    """(c) The roofline of the dry-run records against the H100 SXM data
    sheet's peaks, `report`'s two tables, and the measured times beside
    each bound."""
    from repro_torch.benchmarks import report
    from repro_torch.benchmarks.roofline import roofline_terms
    times = {"prefill": measured["prefill_ms"] / 1e3,
             "decode": measured["decode_tok_ms"] / 1e3,
             "train": measured["train_step_s"]}
    for tag, rec in recs.items():
        name = rec["shape"]
        t = roofline_terms(rec)
        check(all(math.isfinite(v) for v in (t["compute_s"], t["memory_s"],
                                              t["bound_s"])),
              f"roofline of {tag}: {t}")
        print(f"roofline {name}: compute {t['compute_s'] * 1e3:.3f} ms, "
              f"memory {t['memory_s'] * 1e3:.3f} ms (H100 SXM data sheet: "
              f"989 TFLOP/s bf16, 3.35 TB/s), bound {t['bound_s'] * 1e3:.3f}"
              f" ms ({t['dominant'].replace('_s', '')}); measured "
              f"{times[name] * 1e3:.3f} ms [{card}]: roofline fraction "
              f"{t['bound_s'] / times[name]:.3f}, model FLOPs "
              f"{t['model_flops'] / times[name] / 989e12:.3f} of peak")
    print("report dry-run table (counts from a fake trace):")
    print(report.dryrun_table(recs))
    print("report roofline table (H100 SXM data-sheet bounds):")
    print(report.roofline_table(recs))


def tools_check(torch, card: str) -> dict:
    """(d) The six CLIs' `--self-check` on the card, in this process;
    each must return 0.  Returns the histogram kernel's launches by CLI
    (their output goes to build/tools/tools.log)."""
    import importlib
    import os
    from repro_torch.kernels import fleet_hist as fh
    out = Path(__file__).resolve().parent / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    log = out / "tools.log"
    log.unlink(missing_ok=True)
    os.environ["BENCH_FLEET_JSON"] = str(out / "BENCH_fleet.json")
    launches, walls = {}, {}
    for name in TOOLS:
        mod = importlib.import_module(f"repro_torch.tools.{name}")
        fh.ofu_bucket_hist.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with quiet(log):
            rc = mod.main(["--self-check"])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = fh.ofu_bucket_hist.launches
        check(rc == 0, f"{name} --self-check returned {rc} (see {log})")
    print("tools: --self-check on the card, each 0: " + ", ".join(
        f"{n} {walls[n]:.2f} s ({launches[n]} B1 launches)" for n in TOOLS)
        + f" [{card}]")
    return launches


# ---------------------------------------------------------------------------
# 15. the card's own counters
# ---------------------------------------------------------------------------
#: the counter poll's period, and the lead of each window whose readings
#: are left out, so that every reading's own trailing average (NVML's
#: utilization sample period is 1/6 s to 1 s) lies inside the window
COUNTER_POLL_S, COUNTER_SETTLE_S = 0.2, 1.0
#: each window's counted seconds (idle, and each GEMM's repeated calls)
IDLE_S, COUNTER_WINDOW_S = 2.0, 3.0
#: launches between synchronisations in a GEMM window
WINDOW_BATCH = 20
#: a true tensor source must see bf16 GEMMs at least this far above idle,
#: and true-f32 GEMMs (no tensor pipe) below `F32_TPA_MAX`
TPA_BF16_RISE, F32_TPA_MAX = 0.2, 0.1
#: `fleet_live` on the card's NVML: rounds of a few seconds, the poll well
#: inside the §IV-C window, one bucket a round
FLEET_LIVE_ARGS = ["--transport", "pynvml", "--chip", "h100-sxm",
                   "--interval-s", "1", "--round-s", "3", "--bucket-s",
                   "3", "--rounds", "3", "--host", "127.0.0.1"]


class CounterPoller:
    """Polls GPU 0 every `interval_s` on a host thread through the port's
    acquisition tier, `PynvmlTransport` -> `DcgmFieldBackend` (strict, as
    `fleet_live` builds it): readings of (host time, tensor activity as
    the transport reads it, SM clock MHz).  Connects at construction;
    `start`/`stop` bracket each polled stretch; a failed poll is kept in
    `errors` and stops nothing."""

    def __init__(self, interval_s: float):
        from repro_torch.telemetry.backends import (DcgmFieldBackend,
                                                    PynvmlTransport,
                                                    TransportError)
        self._error = TransportError
        self.interval_s = interval_s
        self.transport = PynvmlTransport()
        try:
            self.transport.connect()
        except TransportError as e:
            fail(f"phase 15: NVML did not connect: {e}")
        check(self.transport.n_devices >= 1, "phase 15: NVML sees no GPU")
        self.backend = DcgmFieldBackend(0, self.transport, strict=True)
        self.readings: list = []
        self.errors: list = []
        self._stop = threading.Event()
        self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            t = time.perf_counter()
            try:
                tpa, clk = self.backend.poll(self.interval_s)
                self.readings.append((t, tpa, clk))
            except self._error as e:
                self.errors.append(f"{t:.3f}: {e}")
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        check(not self._thread.is_alive(), "phase 15: the poller hangs")

    def close(self) -> None:
        self.transport.close()

    def window(self, t0: float, t1: float) -> dict:
        """The readings of [t0 + the settle lead, t1]: their count, mean
        tensor activity, mean and least SM clock, and OFU = mean(TPA·f)
        over the H100's f_max (paper Eq. 1)."""
        from repro_torch.core.peaks import H100_SXM
        rows = np.array([(a, c) for t, a, c in self.readings
                         if t0 + COUNTER_SETTLE_S <= t <= t1])
        check(rows.size > 0, f"phase 15: no reading in a {t1 - t0:.2f} s "
              "window")
        tpa, clk = rows[:, 0], rows[:, 1]
        return {"n": len(rows), "s": t1 - t0, "tpa": float(tpa.mean()),
                "clk": float(clk.mean()), "clk_min": float(clk.min()),
                "ofu": float((tpa * clk).mean() / H100_SXM.f_max_mhz)}


def nvml_versions(poller) -> None:
    """Prints the NVML library and bindings behind `poller`, and
    whether `dcgmi` is here to confirm DCGM's tensor-active field id
    (`dcgmi dmon -l` must list 1004 as tensor-pipe activity)."""
    import importlib.metadata
    import shutil
    nv = poller.transport._nv
    try:
        bindings = importlib.metadata.version("nvidia-ml-py")
    except importlib.metadata.PackageNotFoundError:
        bindings = "unknown"
    refused = poller.transport.refused or "none"
    print(f"counters: NVML {nv.nvmlSystemGetNVMLVersion()}, "
          f"nvidia-ml-py {bindings}; sources refused {refused}; tensor "
          f"activity from {poller.transport.tpa_source}")
    if shutil.which("dcgmi") is None:
        print("counters: dcgmi is not on PATH; DCGM's field 1004 "
              "(DCGM_FI_PROF_PIPE_TENSOR_ACTIVE) is not confirmed here")
        return
    out = subprocess.run(["dcgmi", "dmon", "-l"], capture_output=True,
                         text=True, timeout=60).stdout
    rows = [ln for ln in out.splitlines() if " 1004 " in f" {ln} "]
    print(f"counters: dcgmi dmon -l lists 1004 as {rows[:1] or 'nothing'}")
    check(rows and "tensor" in rows[0].lower(),
          "dcgmi does not list 1004 as tensor-pipe activity")


def gemm_window(torch, poller, x, y, kind: str, chip) -> dict:
    """`ops.matmul` under `chip`'s tiles, called again and again for the
    settle lead and `COUNTER_WINDOW_S` while `poller` polls: the window's
    readings, with MFU (theoretical FLOPs over the window's time and the
    type's peak) and Eq. 8's tile correction of the policy."""
    from repro_torch.core.ofu import adjusted_ofu
    from repro_torch.kernels import ops
    (M, K), N = x.shape, y.shape[1]
    n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < COUNTER_SETTLE_S + COUNTER_WINDOW_S:
        for _ in range(WINDOW_BATCH):
            _, prof = ops.matmul(x, y, chip=chip)
        torch.cuda.synchronize()
        n += WINDOW_BATCH
    t1 = time.perf_counter()
    w = poller.window(t0, t1)
    w["mfu"] = n * prof.theoretical_flops / w["s"] \
        / (chip.peak_tflops(kind) * 1e12)
    w["adj"] = adjusted_ofu(w["ofu"], prof.theoretical_flops,
                            prof.profiled_flops)
    w["what"] = (f"{n} x ops.matmul ({M}, {N}, {K}) {kind}, policy "
                 f"{prof.policy.name} (executed/theoretical "
                 f"{prof.profiled_flops / prof.theoretical_flops:.6f})")
    return w


def print_window(name: str, w: dict, source: str, card: str) -> None:
    label = "TPA" if source in ("field", "gpm") else \
        "utilization-based, not TPA"
    mfu = w.get("mfu", 0.0)
    print(f"counters {name} [{source}; {label}]: {w.get('what', 'idle')}; "
          f"{w['n']} readings over {w['s']:.2f} s; mean {source} "
          f"{w['tpa']:.4f}; SM clock mean {w['clk']:.1f}, min "
          f"{w['clk_min']:.0f} MHz; OFU {w['ofu']:.4f}; MFU {mfu:.4f}; "
          f"tile-corrected OFU {w.get('adj', w['ofu']):.4f}, "
          f"{(w.get('adj', w['ofu']) - mfu) * 100:+.2f} points from MFU"
          + (f"; {w['extra']}" if "extra" in w else "") + f" [{card}]")


def counters_phase(torch, dev, card: str, poller, train: dict) -> dict:
    """15. The paper's own measurement on the card.  (a) Fig. 1's sweep
    through B2 again under the H100's tile policies (launched FLOPs ==
    GemmProfile == closed form).  (b) `poller` (NVML through
    `PynvmlTransport` -> `DcgmFieldBackend`) over windows bracketed by
    `torch.cuda.synchronize()`: idle, B2 bf16, int8 and fp32 at N 8,192
    and bf16 at one of Fig. 1's ragged shapes, each under the H100's
    policies, and phase 12's three timed zamba2-7b train steps; each
    window prints its tensor-activity source, mean TPA, SM clock, OFU,
    MFU and the tile-corrected OFU's gap from MFU (paper Table II /
    Fig. 4).  Fails unless NVML connected, every reading passed the
    backend's range checks, every window's SM clock is non-zero and,
    with a true tensor source, bf16 lifts TPA >= 0.2 above idle while
    true f32 stays below 0.1.  (c) `fleet_live --transport pynvml --chip
    h100-sxm` serves its rounds over HTTP with its backend healthy.
    Returns the kernels' launches over the phase (B3 and B4: the train
    window's)."""
    from repro_torch.core.peaks import H100_SXM
    from repro_torch.core.ofu import adjusted_ofu
    from repro_torch.fleet.jobs import _tile_quant_factor
    from repro_torch.flops.accounting import train_step_flops
    from repro_torch.kernels import fleet_hist as fh
    from repro_torch.kernels import gemm
    t_phase = time.perf_counter()
    zero_counts(gemm.gemm_padded)
    fh.ofu_bucket_hist.launches = 0

    # -- (a) Fig. 1's sweep under the H100's tiles --------------------------
    gemm_sweep(torch, dev, card, chip=H100_SXM)
    marks = {"sweep": time.perf_counter()}

    # -- (b) the windows -----------------------------------------------------
    nvml_versions(poller)
    source = poller.transport.tpa_source
    if source in ("field", "gpm"):
        print(f"counters: tensor activity from NVML's {source} source")
    else:
        print("counters: the card exposes no tensor-activity counter to "
              "this process; the rows below read `utilization.gpu`, so "
              "their OFU is utilization-based, not TPA")
    poller.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    time.sleep(COUNTER_SETTLE_S + IDLE_S)
    windows = {"idle": poller.window(t0, time.perf_counter())}
    gen = torch.Generator(device=dev).manual_seed(15)
    n = SWEEP_N[1]
    for kind in SWEEP_KINDS:
        x, y = gemm_inputs(torch, gen, dev, n, n, n, kind)
        windows[f"B2 {kind} N {n}"] = gemm_window(torch, poller, x, y, kind,
                                                  H100_SXM)
        del x, y
    M, N, K = sweep_shapes()[len(SWEEP_N)]
    x, y = gemm_inputs(torch, gen, dev, M, N, K, "bf16")
    windows[f"B2 bf16 ragged ({M}, {N}, {K})"] = gemm_window(
        torch, poller, x, y, "bf16", H100_SXM)
    del x, y
    poller.stop()
    cfg, shape, steps = train["cfg"], train["shape"], train["steps"]
    w = poller.window(train["t0"], train["t1"])
    peak = H100_SXM.peak_tflops("bf16") * 1e12
    model_fl = train_step_flops(cfg, shape, remat=False).total_mxu
    exec_fl = train_step_flops(cfg, shape, remat=True, executed=True).total_mxu
    w["mfu"] = steps * model_fl / w["s"] / peak
    tq = _tile_quant_factor(cfg, H100_SXM)
    w["adj"] = adjusted_ofu(w["ofu"], 1.0, tq)
    mfu_exec = steps * exec_fl / w["s"] / peak
    w["what"] = (f"{steps} of phase 12's {cfg.name} train steps (S "
                 f"{shape.seq_len}, B {shape.global_batch}, bf16; tile "
                 f"factor {tq:.6f})")
    w["extra"] = (f"MFU with remat's recompute {mfu_exec:.4f}, "
                  f"{(w['adj'] - mfu_exec) * 100:+.2f} points")
    windows[f"train {cfg.name}"] = w
    for name, w in windows.items():
        print_window(name, w, source, card)
    marks["windows"] = time.perf_counter()

    check(not poller.errors, f"phase 15: polls failed the backend's checks: "
          f"{poller.errors[:3]}")
    check(poller.backend.healthy, "phase 15: the backend is not healthy")
    for name, w in windows.items():
        check(w["clk_min"] > 0, f"phase 15: {name}: the SM clock read 0")
    if source in ("field", "gpm"):
        idle, bf16 = windows["idle"]["tpa"], windows[f"B2 bf16 N {n}"]["tpa"]
        f32 = windows[f"B2 fp32 N {n}"]["tpa"]
        check(bf16 - idle >= TPA_BF16_RISE,
              f"phase 15: bf16 GEMMs lift TPA {bf16 - idle:.4f} above idle, "
              f"expected >= {TPA_BF16_RISE}")
        check(f32 < F32_TPA_MAX, f"phase 15: true-f32 GEMMs read TPA "
              f"{f32:.4f}, expected < {F32_TPA_MAX}: not the tensor pipe")
    print(f"counters: {len(poller.readings)} readings every "
          f"{COUNTER_POLL_S:g} s, none refused; SM clock non-zero in every "
          f"window" + (f"; bf16 lifts TPA >= {TPA_BF16_RISE} above idle, "
                       f"true f32 stays below {F32_TPA_MAX}"
                       if source in ("field", "gpm") else
                       "; the TPA checks need a tensor source and were not "
                       "made"))
    poller.close()

    # -- (c) fleet_live on the card's NVML -----------------------------------
    fleet_live_check(torch, card)
    marks["fleet_live"] = time.perf_counter()
    split, t = [], t_phase
    for name, mark in marks.items():
        split.append(f"{name} {mark - t:.2f}")
        t = mark
    print(f"counters phase 15: {time.perf_counter() - t_phase:.2f} s ("
          + ", ".join(split) + f" s) [{card}]")
    launches = {"gemm": gemm.gemm_padded.launches,
                "fleet_hist": fh.ofu_bucket_hist.launches,
                **train["launches"]}
    check(launches["gemm"] > 0 and launches["fleet_hist"] > 0,
          f"phase 15 launched {launches}")
    return launches


def fleet_live_check(torch, card: str) -> None:
    """`python -m repro_torch.tools.fleet_live` with `FLEET_LIVE_ARGS`,
    in this process on a thread, serving on a free local port: a
    `FleetClient` must read its fleet series over HTTP while it runs (the
    newest read is printed), and it must return 0 with its backend
    healthy (its output goes to build/counters/fleet_live.log)."""
    import socket
    from repro_torch.serve import FleetClient
    from repro_torch.serve.client import FleetAPIError
    from repro_torch.tools import fleet_live
    out = Path(__file__).resolve().parent / "build" / "counters"
    out.mkdir(parents=True, exist_ok=True)
    log = out / "fleet_live.log"
    log.unlink(missing_ok=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    rc = []
    t0 = time.perf_counter()
    with quiet(log):
        th = threading.Thread(target=lambda: rc.append(fleet_live.main(
            FLEET_LIVE_ARGS + ["--port", str(port)])), daemon=True)
        th.start()
        served, deadline = None, time.perf_counter() + 120
        while th.is_alive() and time.perf_counter() < deadline:
            time.sleep(0.5)
            try:                        # the newest series it serves
                fleet = FleetClient(f"http://127.0.0.1:{port}").fleet()
                served = fleet if fleet.get("t_s") else served
            except (OSError, FleetAPIError):
                pass
        th.join(timeout=60)
    wall = time.perf_counter() - t0
    text = log.read_text()
    check(not th.is_alive(), "fleet_live did not end")
    check(rc == [0], f"fleet_live returned {rc} (see {log})")
    check(served is not None, f"fleet_live served no fleet series over "
          f"HTTP (see {log})")
    health = [ln for ln in text.splitlines() if ln.startswith("backends:")]
    check(health and health[-1].startswith("backends: 1/1 healthy"),
          f"fleet_live's backend: {health[-1:] or 'no health line'}")
    src = [ln for ln in text.splitlines() if ln.startswith("tensor activity")]
    print(f"fleet_live {' '.join(FLEET_LIVE_ARGS)}: rc 0 in {wall:.2f} s; "
          f"{src[0] if src else 'no source line'}; {health[-1]}; served "
          f"over HTTP: {len(served['t_s'])} buckets, mean OFU "
          + ", ".join(f"{v:.4f}" for v in served.get("mean", [])
                      if v is not None) + f" [{card}]")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-cell"]:
        mesh_cell_main(*sys.argv[2:5])
    else:
        main()
