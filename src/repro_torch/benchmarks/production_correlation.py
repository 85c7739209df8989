"""Paper Fig. 5 + Table III + §V-C: 608 production jobs, MFU-vs-OFU
correlation, per-scale error table, and the two FLOPs-miscalculation case
studies.

The fleet is the shared `repro_torch.fleet.table3` fixture (the paper's
exact scale mix; the 288-GPU group runs the DeepSeek-style MoE with the
buggy `naive_moe` counter, 17 of the 256-GPU jobs the hybrid with
`naive_hybrid` — the ~82 affected jobs of §V-C), simulated on the
device; the offline rollups ingest each job's grid through the
histogram kernel on the card (its plain version on the CPU).  This is
the OFFLINE half of the correlation story: batch rollups +
`divergence.analyze` + `correlation.analyze_correlation`.

Emits a `production_correlation` case into `BENCH_fleet.json` with the
headline numbers (r before/after exclusion, flagged counts, MAE).
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.benchmarks.common import (Row, bench_case, merge_bench_json,
                                           sync, timed)
from repro_torch.fleet import table3
from repro_torch.fleet.correlation import analyze_correlation
from repro_torch.fleet.divergence import analyze
from repro_torch.fleet.jobs import JobSpec, simulate_job

_CASES: list[dict] = []


def _build_jobs(device):
    jobs = table3.build_jobs(device=device)
    sync(device)
    return jobs


def run(device=None) -> list[Row]:
    device = resolve_device(device)
    _CASES.clear()
    rows = []
    jobs, us = timed(_build_jobs, device, repeat=1)
    roll, mfu = table3.offline_rollups(jobs)
    points = roll.to_job_points()
    truth = table3.affected_ids(jobs)
    affected = set().union(*truth.values()) if truth else set()

    rep = analyze(points, flag_rel_err=table3.FLAG_REL_ERR)
    flagged = {p.job_id for p in rep.flagged}
    rows.append(Row(
        "fig5.correlation", us / len(points),
        f"n={len(points)} r_all={rep.r_all:.2f} "
        f"r_after_exclusion={rep.r_clean:.2f} flagged={len(rep.flagged)} "
        f"exact_match={flagged == affected} "
        f"mae={rep.mae_all * 100:.1f}pp "
        f"within10pp={rep.frac_within_10pp * 100:.0f}% "
        f"over20pp={rep.frac_over_20pp * 100:.1f}%"))
    flagged_variants = {}
    for p in rep.flagged:
        flagged_variants[p.flops_variant] = \
            flagged_variants.get(p.flops_variant, 0) + 1
    rows.append(Row("fig5.flagged_breakdown", 0.0,
                    " ".join(f"{k}={v}" for k, v in
                             sorted(flagged_variants.items()))))
    for chips, (n, mfu_pct, err) in sorted(rep.by_scale.items()):
        rows.append(Row(f"table3.gpus={chips}", 0.0,
                        f"jobs={n} mfu={mfu_pct * 100:.1f}% "
                        f"abs_err={err * 100:.1f}pp"))

    # ---- the correlation tier proper: OFU/MFU join + ratio detector ----
    crep, us_corr = timed(analyze_correlation, mfu, roll, repeat=1)
    cflagged = {f.job_id for f in crep.flagged}
    rows.append(Row(
        "correlation.miscalc_scan", us_corr / max(crep.n_jobs, 1),
        f"n={crep.n_jobs} r_all={crep.r_all:.2f} "
        f"r_after_exclusion={crep.r_clean:.2f} flagged={len(cflagged)} "
        f"exact_match={cflagged == affected} "
        f"mae={crep.mae * 100:.1f}pp"))

    bench_case(
        _CASES, "production_correlation", round(crep.r_clean, 3),
        "pearson_r",
        jobs=crep.n_jobs,
        r_all=round(crep.r_all, 3),
        r_after_exclusion=round(crep.r_clean, 3),
        flagged=len(cflagged),
        affected=len(affected),
        exact_match=bool(cflagged == affected and flagged == affected),
        mae_pp=round(crep.mae * 100, 2),
        build_wall_s=round(us / 1e6, 3),
    )

    # ---- §V-C case studies (before/after FLOPs-counter fixes) ----
    def job(*args, **kw):
        return simulate_job(JobSpec(*args, **kw), max_devices=1,
                            device=device)

    moe_bad = job("cs1", "deepseek-v3-671b", chips=288,
                  flops_variant="naive_moe", true_duty=0.26, duration_s=240)
    moe_fix = job("cs1f", "deepseek-v3-671b", chips=288,
                  flops_variant="exact", true_duty=0.26, duration_s=240)
    rows.append(Row(
        "sec5c.case1_moe_latent", 0.0,
        f"reported_mfu={moe_bad.app_mfu * 100:.2f}% ofu={moe_bad.ofu * 100:.2f}% "
        f"rel_err={abs(moe_bad.app_mfu - moe_bad.ofu) / moe_bad.ofu * 100:.1f}% "
        f"corrected_mfu={moe_fix.app_mfu * 100:.2f}% "
        f"corrected_rel_err={abs(moe_fix.app_mfu - moe_fix.ofu) / moe_fix.ofu * 100:.1f}%"))
    hyb_bad = job("cs2", "zamba2-7b", chips=1024,
                  flops_variant="naive_hybrid", true_duty=0.2,
                  duration_s=240)
    hyb_fix = job("cs2f", "zamba2-7b", chips=1536, flops_variant="exact",
                  true_duty=0.2, duration_s=240)
    rows.append(Row(
        "sec5c.case2_hybrid", 0.0,
        f"reported_mfu={hyb_bad.app_mfu * 100:.2f}% ofu={hyb_bad.ofu * 100:.2f}% "
        f"rel_err={abs(hyb_bad.app_mfu - hyb_bad.ofu) / hyb_bad.ofu * 100:.1f}% "
        f"fixed_mfu={hyb_fix.app_mfu * 100:.2f}% "
        f"fixed_rel_err={abs(hyb_fix.app_mfu - hyb_fix.ofu) / hyb_fix.ofu * 100:.1f}%"))

    path = merge_bench_json(_CASES)
    print(f"BENCH-JSON {path} cases={len(_CASES)}")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r.csv())
