"""Torch backend of the fused fleet engine: the fleet's counter grids,
simulated on the device.

The counterpart of `repro.fleet.engine_jax`, with the same generative
model and the same structure:

  * jobs grouped by `engine.group_slots`: one padded (D, S_max) grid, one
    jitter draw and one OU recurrence per (interval, clock-model) group;
  * evented duty averages the per-window sub-samples in a loop over the
    n_sub axis, so resident memory stays O(D·S) however finely the
    hardware window is sub-sampled;
  * the clock is `ClockModel.ou_step_constants`' exact one-step-per-
    interval discretization, as a Python loop over time with a (D,)
    carry, updated in place (three launches per step).

The host half (`_group_inputs`) is the same prep as the reference's, in
NumPy.  The device half (`_group_device_sim`) takes its two normal draws
as arguments, so a test can hand it the reference's own draws and hold
the arithmetic to ulp level; `simulate_jobs_torch` draws them from
`torch.Generator`s seeded from the same NumPy stream as the reference.
Equivalence with the reference's grids is therefore statistical (Philox
vs threefry draws).  Grids come back on the device: the port's
`StreamingRollup.add_grid` reduces them there with the CUDA histogram
kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.fleet.engine import EngineParams, JobSlot, group_slots
from repro_torch.telemetry.counters import check_scrape_interval, event_factors
from repro_torch.telemetry.scrape import DeviceGrid


@dataclass
class GroupInputs:
    """Host-side arrays of one fused group, ready for the device half."""

    ratio: np.ndarray            # (J,) full-rate duty per job, f32
    strag: np.ndarray            # (D,) straggler multiplier per row, f32
    dev_job: np.ndarray          # (D,) row -> job, int32
    sig: np.ndarray              # (D,) lognormal jitter σ per row, f32
    ev_base: np.ndarray          # (n_sub, J_e, S) evented duty bases, f32
    ev_rows: np.ndarray          # (R_e,) rows of evented jobs, int32
    ev_job_of_row: np.ndarray    # (R_e,) evented row -> evented job, int32
    base_end: np.ndarray         # (J, S) duty base at window ends, f32
    n_sub: int
    consts: tuple                # (a, sd, f_min, f_max, throttle)

    def tensors(self, device) -> tuple:
        """The device half's positional array arguments."""
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for x in (self.ratio, self.strag, self.dev_job, self.sig,
                       self.ev_base, self.ev_rows, self.ev_job_of_row,
                       self.strag[self.ev_rows], self.base_end)]
        for i in (2, 5, 6):                     # index arrays
            t[i] = t[i].long()
        return tuple(t)


def _group_device_sim(ratio, strag, dev_job, sig, ev_base, ev_rows,
                      ev_job_of_row, strag_e, base_end, z, dw, *,
                      n_sub: int, consts: tuple):
    """Device half of one fused group: (tpa, clock), both (D, S) f32.

    z (D, S) and dw (S, D) are standard normal draws; both are consumed
    in place (z becomes the jitter factor, dw the OU noise) and freed
    here once used, so the caller must hold no other reference to them.
    """
    D, S = z.shape

    # --- duty -> tpa: constant rows for event-free jobs, a mean over the
    # window sub-samples for evented rows --------------------------------
    duty_p = torch.clamp_max(ratio[dev_job] / strag, 1.0)
    tpa = duty_p[:, None].expand(D, S).clone()
    if ev_rows.numel():
        acc = torch.zeros((ev_rows.numel(), S), dtype=torch.float32,
                          device=z.device)
        for base_k in ev_base:                   # base_k: (J_e, S)
            acc += torch.clamp_max(base_k[ev_job_of_row]
                                   / strag_e[:, None], 1.0)
        tpa[ev_rows] = acc * (1.0 / n_sub)
    # single lognormal jitter draw, σ ≈ jitter / n_eff (the NumPy path's
    # mean-of-n-jittered-subsamples dispersion)
    tpa.mul_(z.mul_(sig[:, None]).exp_()).clamp_(0.0, 1.0)
    del z

    # --- clock: exact OU discretization, one step per sample -------------
    a, sd, f_min, f_max, throttle = consts
    # duty at window ends, gathered straight into the time-major (S, D)
    # layout the recurrence walks
    drive = base_end.t()[:, dev_job]
    drive.div_(strag).clamp_max_(1.0)
    cur = f_max * (1.0 - throttle * drive[0])    # mean_clock(duty₀)
    # drive = μ(duty)·(1−a) + σ·dW, built in place
    drive.mul_(-throttle).add_(1.0).mul_(f_max * (1.0 - a))
    drive.add_(dw.mul_(sd))
    del dw
    # the recurrence overwrites each drive row with its clock sample
    tmp = torch.empty_like(cur)
    for t in range(S):
        row = drive[t]
        torch.mul(cur, a, out=tmp)
        row.add_(tmp).clamp_(f_min, f_max)
        cur = row
    return tpa, drive.t().contiguous()


def _group_inputs(members, params: EngineParams) -> Optional[GroupInputs]:
    """Host half: the reference engine's prep (same event factors, same
    n_eff/n_sub policy).  None when the group has no samples."""
    interval = float(members[0][1].interval_s)
    cm = members[0][2]
    strag_list = [np.ones(1) if sl.stragglers is None
                  else np.atleast_1d(np.asarray(sl.stragglers, float))
                  for _, sl, _ in members]
    n_dev = np.array([len(s) for s in strag_list])
    S_max = max(max(int(sl.duration_s / interval), 0)
                for _, sl, _ in members)
    if S_max <= 0:
        return None
    avg_w = check_scrape_interval(interval, strict=False)

    J = len(members)
    step = np.array([sl.profile.step_time_s for _, sl, _ in members])
    mxu = np.array([sl.profile.mxu_time_s for _, sl, _ in members])
    jit = np.array([sl.profile.jitter for _, sl, _ in members])
    n_eff = np.clip(avg_w / np.maximum(step / 4, 1e-3), 8, 4096).astype(int)
    has_ev = np.array([bool(sl.events) for _, sl, _ in members])
    dev_job = np.repeat(np.arange(J), n_dev).astype(np.int32)
    strag = np.concatenate(strag_list).astype(np.float32)
    t_end = (np.arange(S_max) + 1.0) * interval

    ratio = (mxu / step).astype(np.float32)
    sig = (jit / n_eff).astype(np.float32)[dev_job]

    # per-window sub-sample base grids for evented jobs, (n_sub, J_e, S)
    n_sub = 1
    ev_rows = np.empty(0, np.int32)
    ev_job_of_row = np.empty(0, np.int32)
    ev_base = np.empty((1, 0, S_max), np.float32)
    if has_ev.any():
        ev_jobs = np.flatnonzero(has_ev)
        n_sub = int(min(params.n_sub_max, n_eff[ev_jobs].max()))
        offs = (np.arange(n_sub) / n_sub) * avg_w
        ts = (t_end[:, None] - avg_w) + offs[None, :]   # (S_max, n_sub)
        bases = []
        for j in ev_jobs:
            slow, scale = event_factors(members[j][1].events, ts)
            bases.append(((mxu[j] * scale)
                          / (step[j] * slow)).astype(np.float32).T)
        ev_base = np.stack(bases, axis=1)               # (n_sub, J_e, S)
        ev_rows = np.flatnonzero(has_ev[dev_job]).astype(np.int32)
        job_to_e = np.cumsum(has_ev) - 1
        ev_job_of_row = job_to_e[dev_job[ev_rows]].astype(np.int32)

    base_end = np.broadcast_to(ratio[:, None], (J, S_max)).copy()
    for j in np.flatnonzero(has_ev):
        slow_e, scale_e = event_factors(members[j][1].events, t_end - 1e-6)
        base_end[j] = ((mxu[j] * scale_e) / (step[j] * slow_e)) \
            .astype(np.float32)

    a, sd = cm.ou_step_constants(interval)
    consts = (a, sd, cm.chip.f_max_mhz * cm.f_min_frac,
              float(cm.chip.f_max_mhz), cm.throttle_frac)
    return GroupInputs(ratio, strag, dev_job, sig, ev_base, ev_rows,
                       ev_job_of_row, base_end, n_sub, consts)


def _normal(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def _simulate_group_torch(members, out, rng, params, device) -> None:
    """One fused group: host prep, the two draws, the device half, and
    the per-job slices of the padded grid."""
    interval = float(members[0][1].interval_s)
    inp = _group_inputs(members, params)
    if inp is None:
        for i, sl, _ in members:
            n = 1 if sl.stragglers is None else np.atleast_1d(
                sl.stragglers).size
            empty = torch.empty((n, 0), dtype=torch.float32, device=device)
            out[i] = DeviceGrid(interval, empty, empty.clone())
        return
    D, S_max = len(inp.strag), inp.base_end.shape[1]
    # the reference's two key draws, in the same order
    seed_jit, seed_clk = (int(rng.integers(0, 2 ** 31)) for _ in range(2))
    tpa, clock = _group_device_sim(
        *inp.tensors(device), _normal((D, S_max), seed_jit, device),
        _normal((S_max, D), seed_clk, device), n_sub=inp.n_sub,
        consts=inp.consts)
    n_dev = np.bincount(inp.dev_job, minlength=len(members))
    row0 = 0
    for (i, sl, _), nd in zip(members, n_dev):
        Sj = max(int(sl.duration_s / interval), 0)
        out[i] = DeviceGrid(
            interval, tpa[row0:row0 + nd, :Sj].contiguous(),
            clock[row0:row0 + nd, :Sj].contiguous())
        row0 += nd


def simulate_jobs_torch(slots: Sequence[JobSlot], *, seed: int = 0,
                        params: Optional[EngineParams] = None,
                        device=None) -> list[DeviceGrid]:
    """Torch twin of the reference's `simulate_jobs_jax`; one DeviceGrid
    per slot, its tpa/clock tensors (n_devices, n_samples) float32 on
    `device` (the current CUDA device when None)."""
    device = resolve_device(device)
    params = params or EngineParams()
    rng = np.random.default_rng(seed)
    out: list = [None] * len(slots)
    for members in group_slots(slots).values():
        _simulate_group_torch(members, out, rng, params, device)
    return out
