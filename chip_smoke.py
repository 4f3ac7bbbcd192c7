"""Smoke run of tinyopt_tpu_torch on one CUDA GPU.

Builds the package's CUDA kernels from ``tinyopt_tpu_torch/csrc``, holds
each kernel against its plain PyTorch twin on the card (K1 also at the
flagship's 10k x 6 x 6, and its block kernel, d > 64, at d = 65 to 300 in
every way it reads H, with offset views, the alpha-freeze and 10,007
instances, and past 1024 threads at d = 1024, 1100, 2100 and 6000 f32 /
4500 f64 (the wide kernel), timed at (1000, 65, 65), (256, 100, 20),
(64, 300, 20) and (8, 2100, 20); K2
for GN / LM, the dogleg and the history, also at the edges of its launch
plans, printed per shape, and beside an instance whose data is NaN;
K2's SE3 family, the retraction branch (its register kernel, H from the
points), at 10k x 16 in float32 and float64 with LM and the dogleg, at
K = 24 (the warp kernel, timed at 10k x 24 with LM), small batches and
beside a NaN instance; K2's
multi-color branch, Curtis-Powell-Reid probes, one instance a thread, on
Powell's singular function and
Wood's at 10,000 perturbed standard starts, float32 and float64, LM and
the dogleg, bit for bit against the twin and against K2 with the coloring
off, at B = 1, 3, 33, 257 and beside a NaN start), drives the paths — ``batched_optimize``
on the 50-dim Gaussian-prior bench problem at 10,000 instances through the
fused solver (K2) and the "cg" solver (K1), with LM and with the dogleg,
and the fused LM with the history; Powell's and Wood's 10,000 starts
through the fused solver (K2's multi-color branch); then the flagship, batched SE(3) pose
refinement at 10,000 instances of 16 points, through "fused", "cg" and
"cholesky"; then robust curve fits, 10,000 curves of 60 points with 25 %
outliers, by least squares, Huber and Geman-McClure whitening and Huber by
finite differences, through "cg" (the loop and K1); then the first-order
solvers, segments, covariance, multi-start, implicit differentiation and
the log lines (phases 8-12); the sparse solves — the reference's sparse
benchmark, r = 10x - 2 at dims 10, 100 and 1000 and 10,000 instances,
through the block-diagonal, COO and matrix-free paths, the coupled chain
with LM and the dogleg, BlockDiag and SparseSym covariances (phase 13);
ICP on 4,096 cloud pairs through "cholesky" and "cg" (K1 at
(4096, 6, 6)), the scan-sized 8 pairs of 10,000 points and robust ICP
under outliers (phase 14); SEn3<3> prior solves of 10,000 instances
(phase 15); bundle adjustment by Schur complement — bench_ba's 100
cameras x 5,000 landmarks through schur_optimize with LM, the dogleg,
refinement and the PCG reduced solve, the card against the CPU port in
float64, and 1,000 small problems through the batched Schur system and
the dense loop with "cholesky" and "cg" (K1 at (1000, 96, 96)) (phase
16); the chain solver — bench_pose_graph's 5,000 poses + 100 loop
closures in float32 by cyclic reduction, a 200-pose float64 graph on the
card against the CPU port's scan, ms an LM iteration, one solve by each
method, the marginals, and launches an iteration and the busy share
under torch.profiler (phase 17, ``[chain]`` lines); the sparse-observation
Schur system — bench_ba_sparse's 1,000 cameras x 50,000 landmarks in
float32 by each reduced-solve route, the card against the CPU port in
float64, the covariance and the committed BAL excerpt (phase 18,
``[ba_sparse]`` lines); the K-bucketed sparse-observation BA at BAL
Trafalgar-257's size (257 cameras, 65,132 landmarks, ~226,000
heavy-tailed observations) in float32, a float64 cut against the padded
layout and the CPU port, the excerpt bucketed, and bench_bal_robust's
Geman-McClure anneal (phase 19, ``[ba_buckets]`` lines); multi-device
solving (``tinyopt_tpu_torch.parallel``) on a one-rank NCCL mesh —
batched_optimize(mesh=) on the bench problem bit for bit against the
unsharded call, sharded_optimize through "cg", phase 18a's and 19a's BA
sharded against their unsharded solves — and the six dryrun axes on two
gloo ranks sharing the card (phase 20, ``[mesh]`` and ``[dryrun]`` lines);
K2 on families generated from the traced residual — the robust curve fits
and the JAX fused suite's residuals (phase 21, ``[curves_fused]`` and
``[generated]`` lines) and, traced through the retraction, residuals on
SO3, SE3, SE23 and SEn3 leaves, a batched SO3 leaf, a {SE3, bias} pytree
and the robust point-to-point SE3 fit (phase 22, ``[manifold]`` lines),
and past max(P, D, n_res) = 64 in K2's warp kernel, the residual emitted
for one warp — the robust point-to-point SE3 fit at ICP's 128 points a
pair, the banded residual at d = 128 with its 2-color branch and without,
the Huber curve fit at 256 samples (phase 23, ``[wide]`` lines) —
each with the launch counts set to 0 just before it and
read just after, and checks what comes out (the flagship's poses against
the true ones, the curves' costs against float64 solves and their fits
against the true curve, the sparse paths against x = 0.2, the dense
solve, each other and the CPU port, ICP poses against the true ones and
the CPU port's, the BA's reprojection RMSE against bench_ba's criterion
and the Schur solves against the dense ones and the CPU port's, the pose
graph's cost against bench_pose_graph's chi^2 criterion and the card's
chain solves and marginals against the CPU port's).  Every
phase that fails raises, so the script
exits non-zero; without a CUDA device it exits non-zero before printing
any result.

    python3 chip_smoke.py

Output: one line per phase (``[time]`` lines: the seconds of each part as
it ends), then a line ``{"kernels": [...]}`` with each
kernel's launches on the main path (and on each path in
``path_launches``), its largest disagreement with its twin, its time
beside the twin's, and its memory bound (``bound_ms``) and the share of it
the kernel reaches (float32, and float64 as ``*_f64``; K2's time on
Jennrich-Sampson 4096 x 2 as ``js_ms``, its dogleg as ``dl_ms``,
``dl_ms_f64`` and ``dl_js_ms``, LM with the history as ``hist_ms``; the
SE3 family's register kernel in an entry of its own, as ``se3_ms``,
``se3_ms_f64``, ``se3_dl_ms``..., with its bound, bytes or operations, as
``se3_bound_ms`` and the split of its LM call as ``se3_iter0_ms`` and
``se3_iter_us``; the multi-color branch,
K2's one-lane instance, in an entry of its own, as ``mc_powell_ms``,
``mc_wood_dl_ms_f64``, ``mc_powell_off_ms``..., with its twin's time,
bound and share, and the solves/s of its path through
``batched_optimize`` as ``mc_powell_path_solves_per_s``...; the
generated families on the warp kernel in an entry of their own, as
``wide_icp_huber_ms``, ``wide_banded_dl_plain_ms``...; K1 at
d = 6 as ``d6_ms`` and its
launches on the curve fits as ``curve_launches``, and at ICP's
(4096, 6, 6) as ``icp_ms``, ``icp_launches``..., and at the batched
BA's (1000, 96, 96) as ``ba_ms``, ``ba_ms_f64``, ``ba_launches``...);
the card's name and power limit; and last ``{"ok": true, "device":
{...}}``.  The full record is also written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, DIMS = 10_000, 50
REPS = 5
# H100 SXM data sheet at 700 W: device memory rate, and the peak rate of
# float32 / float64 arithmetic outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def log(*a):
    print(*a, flush=True)


def bench_options(to, solver="fused", **kw):
    """The options of bench.py (reference benchmarks/options.h:10-27);
    ``kw`` replaces fields (``solver_type``, ``save_history``...)."""
    return to.Options(**{**dict(
        max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
        min_step_norm2=1e-16, max_consec_failures=3, save_history=False,
        hessian=to.HessianOptions(save_last=False, solver=solver, cg_iters=8,
                                  carry_system=False, fused_block=512)),
        **kw})


def gpu_ms(fn, n=1, warmup=1):
    """Mean device milliseconds per call of ``fn`` over ``n`` calls.

    CUDA events bracket the calls, which the host queues behind ~0.1 s of
    device sleep: a call that never waits for the device is timed without
    its launch overhead, one that synchronizes (the twins' host loops) is
    timed with it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def k1_bound(B, d, iters, itemsize):
    """Least time in ms K1's work could take on the card, and what sets it:
    H and b read once and x written once over the memory rate ("bytes"),
    or its operations (2d² + 11d an iteration) over the peak rate
    ("operations"), whichever is larger."""
    t_bytes = (B * d * d + 2 * B * d) * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = B * iters * (2 * d * d + 11 * d) / PEAK_FLOPS[itemsize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_bound_ms(B, d, itemsize, cap=0):
    """K2's bytes on the prior problem over the memory rate: x0, y and
    inv_std read, x and g written, 8 scalars an instance written, and with
    the history the (B, cap) rows errs and deltas2 (itemsize each) and
    successes (one byte)."""
    return ((5 * B * d + 8 * B) * itemsize + B * cap * (2 * itemsize + 1)
            ) / HBM_BYTES_PER_S * 1e3


# The least arithmetic the SE3 solve needs (flops; a multiply and an add
# count one each), whatever way a kernel computes it.  r_k = R p_k + t - q_k
# has J_k = R [I, -[p_k]x], so for each point: the residual and its square
# (R p: 15, + t - q: 6, square and sum: 6); g = J'r as R'(sum r_k) and
# R'(sum (R p_k) x r_k) (3 + 12).  Once an instance, since J'J =
# sum [I, -[p]x]' R'R [I, -[p]x] with R'R = I needs the points only through
# sum p_k and sum p_k p_k': those sums (3 + 12 a point) and H from them
# (190).  For each iteration: R(q) (28), the two R' products (30); one
# Jacobi-PCG step on the 6 x 6 system as K1 counts it (2 d^2 + 11 d); the
# retraction (exp_q, q (x) dq, R V(omega) rho + t: 100); the dogleg's g'Hg
# and blend (110).
SE3_MIN_FLOPS = dict(point_once=15, instance_once=190, residual=27, grad=15,
                     pose=58, pcg_step=2 * 36 + 11 * 6, retract=100,
                     dogleg=110)
SE3_K = 16                     # points an instance: the flagship's
SE3_CELL = "10k x 16"
SE3_WARP_K = 24                # points: past 21, K2's warp kernel


def se3_options(to, solver="fused", **kw):
    """``bench_se3``'s options (benchmarks/run_benchmarks.py:240-242):
    every other field at its default; ``kw`` replaces fields."""
    return to.Options(**{**dict(
        max_iters=10, max_consec_failures=3,
        hessian=to.HessianOptions(save_last=False, solver=solver,
                                  carry_system=False)), **kw})


def k2_se3_bound(out, opts, n_points, itemsize, dogleg=False, extra=0):
    """Least time in ms of K2's SE3 solve on the card for this run's
    instances, and what sets it: the bytes (x0, points and targets in; x,
    g and 8 scalars an instance out) over the memory rate, or the least
    operations the solve needs (``SE3_MIN_FLOPS``) over the peak rate —
    for each instance its points' sums and H once, and for each of its outer
    iterations (``num_iters``, rejected ones included) a residual and
    gradient over its points, H, one PCG solve of ``cg_iters`` steps (D
    when 0), the retraction and ``extra`` flops.  Retried proposals and
    the dogleg's damped solves are not counted."""
    B = out.num_iters.shape[0]
    K, D, f = n_points, 6, SE3_MIN_FLOPS
    cg = opts.hessian.cg_iters or D
    per_iter = (K * (f["residual"] + f["grad"]) + f["pose"]
                + cg * f["pcg_step"] + f["retract"]
                + (f["dogleg"] if dogleg else 0) + extra)
    ops = (B * (K * f["point_once"] + f["instance_once"])
           + float(out.num_iters.double().sum()) * per_iter)
    t_ops = ops / PEAK_FLOPS[itemsize] * 1e3
    t_bytes = ((7 + 6 * K) * B + (7 + 6 + 8) * B) * itemsize \
        / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The least arithmetic an iteration of one instance of Powell's singular
# function and of Wood's needs (flops; a multiply and an add count one
# each), whatever way a kernel computes it: the residuals (11 and 17), the
# Jacobian's 8 and 10 non-zeros (10 and 12), g = J'r over them (16, 20),
# the 4 x 4 J'J from the rows' 2 or 1 non-zeros (24, 28), the cost (8,
# 12), the damping (8), a Cholesky solve of the 4 x 4 system (75) and the
# step (4); the dogleg adds g'Hg, the step norms and the blend (70).
MC_MIN_FLOPS = dict(powell=156, wood=176, dogleg=70)
MC_EDGE_ITERS = 50           # 4c's small batches and NaN starts
MC_HOLD_ITERS = 50           # 4c's twin hold of the 10k cells (timed: 200)
MC_STARTS = {"powell": (3.0, -1.0, 0.0, 1.0),
             "wood": (-3.0, -1.0, -3.0, -1.0)}


def least_bound(out, d, itemsize, per_iter):
    """Least time in ms of a K2 solve of this run's instances of a family
    without data, and what sets it: the bytes (x0 in; x, g and 8 scalars
    an instance out, d values each vector) over the memory rate, or the
    least operations (``per_iter`` flops over each instance's
    ``num_iters``) over the peak rate, whichever is larger."""
    B = out.num_iters.shape[0]
    ops = float(out.num_iters.double().sum()) * per_iter
    t_ops = ops / PEAK_FLOPS[itemsize] * 1e3
    t_bytes = (3 * d + 8) * B * itemsize / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mc_bound(out, name, itemsize, dogleg=False):
    """``least_bound`` of this run's Powell or Wood instances
    (``MC_MIN_FLOPS`` an iteration)."""
    per_iter = MC_MIN_FLOPS[name] + (MC_MIN_FLOPS["dogleg"] if dogleg else 0)
    return least_bound(out, 4, itemsize, per_iter)


# The least arithmetic an iteration of Jennrich-Sampson (m residuals, 2
# unknowns) needs (flops; an exponential counts one): for each residual
# c x1 and c x2 (2), the two exponentials (2), r_i (3), J_i from the
# exponentials (2), its part of g = J'r (4), of the 2 x 2 J'J (6) and of
# the cost (2); then the damping, the 2 x 2 solve and the step (20); the
# dogleg adds g'Hg, the step norms and the blend (30).
JS_MIN_FLOPS = dict(residual=21, iteration=20, dogleg=30)


def js_bound(out, m, itemsize, dogleg=False):
    """``least_bound`` of this run's Jennrich-Sampson instances."""
    per_iter = (JS_MIN_FLOPS["residual"] * m + JS_MIN_FLOPS["iteration"]
                + (JS_MIN_FLOPS["dogleg"] if dogleg else 0))
    return least_bound(out, 2, itemsize, per_iter)


def timed(fn):
    """(fn(), device ms of the one call, host synchronized)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


class PathLaunches(dict):
    """Launch counts by path.  Each record also takes K2's warp-kernel
    count (``fused_solve.warp_launches``, set to 0 with the others before
    the path runs), read when the record is made."""

    def __init__(self, cuda_solver):
        super().__init__()
        self.k2 = cuda_solver.fused_solve

    def __setitem__(self, key, counts):
        super().__setitem__(key, {**counts,
                                  "K2 warp": self.k2.warp_launches})


def mc_check(ref, got, what):
    """K2's Powell and Wood families against the twin: bit for bit in x,
    g, cost, iterations, failure counts, stop reasons and the history rows
    (the closed-form
    jvp and vjp take torch.func's products and sums in its order,
    csrc/solver.cuh), in float32 and float64; returns max |x - x_twin|
    over the finite entries (0)."""
    (xr, outr), (xg, outg) = ref, got
    for a, b, field in ((xg, xr, "x"), (outg.final_grad, outr.final_grad, "g"),
                        (outg.final_cost.cost, outr.final_cost.cost, "cost"),
                        (outg.errs, outr.errs, "errs"),
                        (outg.deltas2, outr.deltas2, "deltas2")):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what}: {field}")
    for field in ("stop_reason", "num_iters", "num_failures",
                  "num_consec_failures", "num_hist", "successes"):
        assert torch.equal(getattr(outg, field), getattr(outr, field)), \
            f"{what}: {field}"
    return (torch.nan_to_num(xg) - torch.nan_to_num(xr)).abs().max().item()


def pose_errors(to, x, true_pose):
    """Largest rotation angle (rad) and translation error (units) of the
    poses ``x`` against ``true_pose``."""
    from tinyopt_tpu_torch.manifolds import SO3
    rot = (x.rotation @ SO3(true_pose.rotation.wxyz).inverse()).log()
    return (torch.linalg.vector_norm(rot, dim=-1).max().item(),
            torch.linalg.vector_norm(x.translation - true_pose.translation,
                                     dim=-1).max().item())


def se3_check(ref, got, dtype, what):
    """K2's SE3 family against its twin (PERF.md §6): float64 x to rtol
    1e-10, stop reasons equal on every instance, iterations within 1;
    float32 x to tests/test_fused.py:327-332's rtol 1e-4, atol 1e-5, the
    same success on every instance.  Returns max |x_k - x_twin| and the
    largest iteration and failure-count gaps."""
    (xr, outr), (xg, outg) = ref, got
    if dtype == torch.float64:
        torch.testing.assert_close(xg, xr, rtol=1e-10, atol=1e-12,
                                   equal_nan=True, msg=what)
        assert torch.equal(outg.stop_reason, outr.stop_reason), what
    else:
        torch.testing.assert_close(xg, xr, rtol=1e-4, atol=1e-5,
                                   equal_nan=True, msg=what)
    assert torch.equal(outg.succeeded(), outr.succeeded()), what
    di = (outr.num_iters - outg.num_iters).abs().max().item()
    df = (outr.num_failures - outg.num_failures).abs().max().item()
    if dtype == torch.float64:
        assert di <= 1, f"{what}: iteration gap {di}"
    fin = torch.isfinite(xr) & torch.isfinite(xg)
    err = (xg - xr)[fin].abs().max().item() if bool(fin.any()) else 0.0
    return err, di, df


def se3_check_few(ref, got, x64, what):
    """K2's SE3 family against its float32 twin where three points pin a
    pose loosely: the twin itself lies farther than ``se3_check``'s atol
    from the float64 solve there (its late accept / reject decisions follow
    rounding, PERF.md), so x is held as tests/test_torch_se3.py's
    ``_se3_kernel_parity`` holds it — rtol 1e-4, atol max(1e-5, twice the
    twin's own gap to the float64 twin ``x64``) — with the same success.
    Returns max |x_k - x_twin|, the twin's gap and max |x_k - x_64|."""
    (xr, outr), (xg, outg) = ref, got
    gap = (xr.double() - x64).nan_to_num().abs().max().item()
    torch.testing.assert_close(xg, xr, rtol=1e-4, atol=max(1e-5, 2 * gap),
                               equal_nan=True, msg=what)
    assert torch.equal(outg.succeeded(), outr.succeeded()), what
    fin = torch.isfinite(xr) & torch.isfinite(xg)
    err = (xg - xr)[fin].abs().max().item() if bool(fin.any()) else 0.0
    d64 = (xg.double() - x64).nan_to_num().abs().max().item()
    return err, gap, d64


def offset_view(H):
    """The values of ``H`` in a contiguous view one element past an aligned
    base: K1 cannot take one bulk copy per instance from it."""
    flat = torch.empty(H.numel() + 1, dtype=H.dtype, device=H.device)
    view = flat[1:].view(H.shape)
    view.copy_(H)
    return view


def assert_parity(ref, got, *, rtol, atol, iter_slack=1, fail_slack=0,
                  grad_rtol=1e-4, what=""):
    """tests/test_fused.py:51 ``_assert_parity`` on torch tensors; returns
    max |x_got - x_ref|."""
    (xr, outr), (xg, outg) = ref, got
    torch.testing.assert_close(xg, xr, rtol=rtol, atol=atol, equal_nan=True,
                               msg=what)
    assert torch.equal(outr.succeeded(), outg.succeeded()), what
    assert torch.equal(outr.converged(), outg.converged()), what
    di = (outr.num_iters - outg.num_iters).abs().max().item()
    df = (outr.num_failures - outg.num_failures).abs().max().item()
    assert di <= iter_slack, f"{what}: iteration gap {di}"
    assert df <= fail_slack, f"{what}: failure-count gap {df}"
    torch.testing.assert_close(outg.final_cost.cost, outr.final_cost.cost,
                               rtol=rtol, atol=atol, equal_nan=True, msg=what)
    torch.testing.assert_close(outg.final_grad, outr.final_grad,
                               rtol=grad_rtol, atol=1e-5, equal_nan=True,
                               msg=what)
    return (xg - xr).abs().max().item()


# ---- phases 8-12: the first-order solvers, segments, covariance, multi-
# start, implicit differentiation and the log lines (slice B item 11) ----

MLP_HIDDEN, MLP_POINTS = 16, 64


def mlp_problem(B, dtype, dev, seed):
    """10,000-style independent regressions of examples/nn_training.py's
    1-16-1 tanh MLP: 49 parameters a curve as a dict with sorted keys
    (b1, b2, w1, w2), each on its own 64 points y = sin(a x) + 0.05 noise,
    x in [-2, 2], a ~ U(1, 3) and the starts ~ N(0, 0.5²), from ``seed``.
    Returns (params0, y (B, 64), the cost of one instance)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.linspace(-2, 2, MLP_POINTS, dtype=dtype, device=dev)
    a = 1.0 + 2.0 * torch.rand((B,), generator=g, dtype=dtype, device=dev)
    y = torch.sin(a[:, None] * xs) + 0.05 * torch.randn(
        (B, MLP_POINTS), generator=g, dtype=dtype, device=dev)

    def s(*shape):
        return 0.5 * torch.randn((B,) + shape, generator=g, dtype=dtype,
                                 device=dev)
    p0 = {"b1": s(MLP_HIDDEN), "b2": s(1), "w1": s(MLP_HIDDEN, 1),
          "w2": s(1, MLP_HIDDEN)}

    def mse(p, yi):
        xv = torch.linspace(-2, 2, MLP_POINTS, dtype=yi.dtype,
                            device=yi.device)
        h = torch.tanh(p["w1"] @ xv[None, :] + p["b1"][:, None])
        return torch.mean(((p["w2"] @ h + p["b2"][:, None])[0] - yi) ** 2)
    return p0, y, mse


def mlp_runs(to):
    """examples/nn_training.py:58-71's options, plus AdamW (weight decay
    1e-4) and GD with Barzilai-Borwein rates."""
    return {
        "gd": to.Options(solver_type=to.GradientDescent, max_iters=500,
                         max_consec_failures=0, gd=to.GDOptions(lr=0.05)),
        "gd_bb": to.Options(solver_type=to.GradientDescent, max_iters=500,
                            max_consec_failures=0,
                            gd=to.GDOptions(lr=0.05, adaptive="bb")),
        "sgd": to.Options(solver_type=to.SGD, max_iters=500,
                          max_consec_failures=0,
                          sgd=to.SGDOptions(lr=0.02, momentum=0.9)),
        "adam": to.Options(solver_type=to.Adam, max_iters=500,
                           max_consec_failures=0,
                           adam=to.AdamOptions(lr=0.05)),
        "adamw": to.Options(solver_type=to.AdamW, max_iters=500,
                            max_consec_failures=0,
                            adam=to.AdamOptions(lr=0.05, weight_decay=1e-4)),
        "lbfgs": to.Options(solver_type=to.LBFGS, max_iters=500,
                            max_consec_failures=30,
                            lbfgs=to.LBFGSOptions(memory=10)),
    }


# Card against CPU on the same float64 curves, over the first
# FO_HOLD_ITERS iterations (the CPU's host loop is most of phase 8's time;
# the readings below are of 500).  The sums of the card's kernels and the
# CPU's run in other orders, and over the iterations of a nonconvex fit
# the rounding can grow: Barzilai-Borwein rates and L-BFGS
# curvature pairs amplify it (on an H100 80GB HBM3, 700 W, the card
# against itself from starts scaled by 1 + 1e-15, the probe, parted 244
# and 256 of 256 curves, first 1e-9 apart at iterations 38 and 28 at the
# earliest; card against CPU: 38 and 28 as well; GD and SGD parted none,
# Adam and AdamW 3, the earliest at iteration 224).  So:
# - every curve, every solver: the cost of each iteration (the errs row)
#   within 1e-9 relative of the CPU's through iteration FO_HORIZON - 1,
#   just under the earliest 1e-9 divergence the probe showed (28);
# - where the probe parts few curves (at most FO_PROBE_FEW), the curves
#   whose final costs differ by more than FO_COST_RTOL or whose stop
#   reasons differ number at most the probe's count + FO_PARTED_SLACK;
#   where it parts most (BB, L-BFGS) each curve's end is chaos, and the
#   median final MSE is held within FO_MEDIAN_RTOL of the CPU's instead
#   (readings 0.37 % and 0.30 %);
# - every curve a success on both sides.
FO_COST_RTOL = 1e-6
FO_HORIZON = 25
FO_HOLD_ITERS = 100          # the float64 hold's depth (the timed runs: 500)
FO_PROBE_FEW = 12
FO_PARTED_SLACK = 5
FO_MEDIAN_RTOL = 0.05


def fo_parted(card, cpu):
    """(indices of the parted instances, each instance's first iteration
    whose cost differs by more than 1e-9 relative, or -1)."""
    (_, oc), (_, op) = card, cpu
    cc, cp = oc.final_cost.cost.cpu(), op.final_cost.cost.cpu()
    gap = ((cc - cp).abs() / cp.abs().clamp(min=1e-300))
    parted = ((gap > FO_COST_RTOL)
              | (oc.stop_reason.cpu() != op.stop_reason.cpu()))
    idx = torch.nonzero(parted).flatten().tolist()
    ec, ep = oc.errs.cpu(), op.errs.cpu()
    apart = (ec - ep).abs() > 1e-9 * ep.abs()
    first = torch.where(apart.any(dim=1),
                        apart.to(torch.int8).argmax(dim=1), -1)
    return idx, first


def earliest(first):
    """The earliest first-apart iteration over the curves, or -1."""
    hit = first[first >= 0]
    return int(hit.min()) if len(hit) else -1


def phase8(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """First-order solvers at full width: 10,000 MLP regressions (float32)
    with six solvers, then the bench problem in cost mode with Adam and
    L-BFGS; no TPU kernel is on these paths (as in the JAX package: the
    first-order proposals are elementwise passes), so each path's launch
    counts must read 0."""
    from tinyopt_tpu_torch.models.problems import make_prior_batch
    p0, y, mse = mlp_problem(BATCH, torch.float32, dev, seed=8)
    runs = mlp_runs(to)
    rec = record["first_order"] = {}
    # the float64 hold: the first 256 curves, on the card and on the CPU
    n64 = 256
    p64 = {k: v[:n64].double() for k, v in p0.items()}
    y64 = y[:n64].double()
    # untimed warm-up: the first call of the vmapped gradient pays
    # one-time work, which would count against the first solver timed
    to.batched_optimize(p0, mse, runs["gd"].replace(max_iters=2),
                        data_batch=y, mode="cost")
    for name, opts in runs.items():
        key = f"fo_mlp_{name}"
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        (p, out), ms = timed(lambda: to.batched_optimize(
            p0, mse, opts, data_batch=y, mode="cost"))
        n = path_launches[key] = {"K1": cuda_cg.cg_solve.launches,
                                  "K2": cuda_solver.fused_solve.launches}
        assert n == {"K1": 0, "K2": 0}, f"{key}: launches {n}"
        assert all(bool(torch.all(torch.isfinite(v))) for v in p.values())
        assert bool(torch.all(out.succeeded())), key
        stops = torch.bincount(out.stop_reason.clamp(min=0),
                               minlength=8).tolist()
        hold = opts.replace(max_iters=FO_HOLD_ITERS)
        card = to.batched_optimize(p64, mse, hold, data_batch=y64,
                                   mode="cost")
        cpu = to.batched_optimize({k: v.cpu() for k, v in p64.items()}, mse,
                                  hold, data_batch=y64.cpu(), mode="cost")
        probe = to.batched_optimize(
            {k: v * (1 + 1e-15) for k, v in p64.items()}, mse, hold,
            data_batch=y64, mode="cost")
        idx, first = fo_parted(card, cpu)
        idx_p, first_p = fo_parted(card, probe)
        few = len(idx_p) <= FO_PROBE_FEW
        limit = len(idx_p) + FO_PARTED_SLACK
        med = [o.final_cost.cost.median().item()
               for o in (card[1], cpu[1], probe[1])]
        med_gap = abs(med[0] - med[1]) / med[1]
        r = rec[name] = {
            "ms": ms, "solves_per_s": BATCH / (ms / 1e3),
            "mean_iters": out.num_iters.float().mean().item(),
            "stops": stops,
            "median_mse": out.final_cost.cost.median().item(),
            "f64_parted": idx,
            "f64_first_apart": earliest(first),
            "f64_probe_parted": len(idx_p),
            "f64_probe_first_apart": earliest(first_p),
            "f64_max_cost_gap": (
                (card[1].final_cost.cost.cpu() - cpu[1].final_cost.cost).abs()
                / cpu[1].final_cost.cost).max().item(),
            "f64_median_mse": med, "f64_median_gap": med_gap}
        held = (f"parted {len(idx)} (limit {limit})" if few else
                f"parted {len(idx)} (no count limit: the probe parts most), "
                f"median MSE gap {med_gap:.3e} (limit {FO_MEDIAN_RTOL})")
        log(f"[first-order] MLP {name}: {r['solves_per_s']:.1f} solves/s "
            f"({BATCH} curves, {ms:.1f} ms), mean iters "
            f"{r['mean_iters']:.2f}, stops {stops}, median final MSE "
            f"{r['median_mse']:.4e}; float64 card vs CPU on "
            f"{y64.shape[0]} curves, {FO_HOLD_ITERS} iterations: largest "
            f"cost gap "
            f"{r['f64_max_cost_gap']:.3e}, {held}; first 1e-9 apart at "
            f"iteration {r['f64_first_apart']} (held >= {FO_HORIZON}; -1 "
            f"never); the 1 + 1e-15 probe parted {len(idx_p)}, first apart "
            f"at {r['f64_probe_first_apart']}; median MSE card / CPU / "
            f"probe {med[0]:.4e} / {med[1]:.4e} / {med[2]:.4e}")
        assert bool(torch.all((first < 0) | (first >= FO_HORIZON))), \
            f"{key}: a curve apart before iteration {FO_HORIZON}"
        if few:
            assert len(idx) <= limit, f"{key}: {len(idx)} curves parted"
        else:
            assert med_gap <= FO_MEDIAN_RTOL, f"{key}: median gap {med_gap}"
        assert bool(torch.all(card[1].succeeded())) and bool(
            torch.all(cpu[1].succeeded())), key
    # the bench problem in cost mode: Σ of squared whitened residuals, its
    # minimum x = y exactly
    data, x0 = make_prior_batch(BATCH, DIMS, torch.float32, seed=9,
                                device=dev)

    def prior_cost(x, d):
        r = (x - d.y) * d.inv_std
        return torch.sum(r * r)
    prior_runs = {
        "adam": to.Options(solver_type=to.Adam, max_iters=1000,
                           max_consec_failures=0,
                           adam=to.AdamOptions(lr=0.05)),
        "lbfgs": to.Options(solver_type=to.LBFGS, max_iters=500,
                            max_consec_failures=30,
                            lbfgs=to.LBFGSOptions(memory=10)),
    }
    for name, opts in prior_runs.items():
        key = f"fo_prior_{name}"
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        (x, out), ms = timed(lambda: to.batched_optimize(
            x0, prior_cost, opts, data_batch=data, mode="cost"))
        n = path_launches[key] = {"K1": cuda_cg.cg_solve.launches,
                                  "K2": cuda_solver.fused_solve.launches}
        assert n == {"K1": 0, "K2": 0}, f"{key}: launches {n}"
        gap = (x - data.y).abs().max().item()
        stops = torch.bincount(out.stop_reason.clamp(min=0),
                               minlength=8).tolist()
        rec[f"prior_{name}"] = {
            "ms": ms, "solves_per_s": BATCH / (ms / 1e3),
            "mean_iters": out.num_iters.float().mean().item(),
            "stops": stops, "max_abs_x_minus_y": gap}
        log(f"[first-order] prior-50 cost mode {name}: "
            f"{BATCH / (ms / 1e3):.1f} solves/s ({ms:.1f} ms), mean iters "
            f"{out.num_iters.float().mean().item():.2f}, stops {stops}, "
            f"max|x - y| = {gap:.3e}")
        assert bool(torch.all(out.succeeded())), key
        assert gap < 1e-4, f"{key}: max|x - y| = {gap}"


def assert_same_solve(a, b, what):
    """Bit for bit: x, stop reasons, iteration counts and the history."""
    (xa, oa), (xb, ob) = a, b
    assert torch.equal(xa, xb), f"{what}: x"
    for k in ("stop_reason", "num_iters", "num_hist", "errs", "deltas2",
              "successes"):
        assert torch.equal(getattr(oa, k), getattr(ob, k)), f"{what}: {k}"


def phase9(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """Segments, a checkpoint and the timeout loop on the main path:
    prior-50 / 10k / f32, LM through "cg" (K1 each iteration)."""
    import tempfile

    from tinyopt_tpu_torch import checkpoint as ck
    from tinyopt_tpu_torch.models.problems import (make_prior_batch,
                                                   prior_residual)
    data, x0 = make_prior_batch(BATCH, DIMS, torch.float32, seed=10,
                                device=dev)
    d_ex = type(data)(*(a[0] for a in data))
    opts = bench_options(to, "cg", save_history=True)
    rec = record["segments"] = {}
    ref = to.batched_optimize(x0, prior_residual, opts, data_batch=data)
    seg = ck.segment_solver(prior_residual, opts, x0[0],
                            iters_per_segment=2, data_example=d_ex)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "segment.pt")
        seen = []

        def round_trip_once(st):
            seen.append(1)
            if len(seen) > 1:
                return st
            ck.save_state(path, st)
            return ck.load_state(path, seg.abstract_state(x0))

        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        x, out, _ = seg.run(x0, data, on_segment=round_trip_once)
        torch.cuda.synchronize()
        n = path_launches["segments_cg"] = {
            "K1": cuda_cg.cg_solve.launches,
            "K2": cuda_solver.fused_solve.launches}
    assert n["K1"] > 0 and n["K2"] == 0, f"segments: launches {n}"
    assert len(seen) >= 2, "segments: fewer than two segments"
    assert_same_solve((x, out), ref, "segments with a checkpoint")
    assert bool(torch.all(out.succeeded()))
    # segment overhead: the same segments against one solve, both after
    # the calls above (no first-call work in either)
    count = []
    (_, seg_ms) = timed(lambda: seg.run(
        x0, data, on_segment=lambda st: count.append(1) or st))
    (_, ref_ms) = timed(lambda: to.batched_optimize(
        x0, prior_residual, opts, data_batch=data))
    rec.update(launches=n, segments=len(count), ms=seg_ms,
               unsegmented_ms=ref_ms,
               overhead_ms_per_segment=(seg_ms - ref_ms) / len(count),
               mean_iters=out.num_iters.float().mean().item())
    log(f"[segments] prior-50 / 10k / f32 cg, 2 iterations a segment: "
        f"launches {n}; x, stop reasons, iterations and history equal "
        f"(torch.equal) to one solve, through a save_state / load_state "
        f"after the first segment; {len(count)} segments {seg_ms:.2f} ms "
        f"against {ref_ms:.2f} ms unsegmented: overhead "
        f"{rec['overhead_ms_per_segment']:.3f} ms a segment")
    # the Stepper: 3 steps + the rollback slot against max_iters=3
    o3 = opts.replace(max_iters=3)
    ref3 = to.batched_optimize(x0, prior_residual, o3, data_batch=data)
    st = to.stepper(prior_residual, o3, x0[0], data_example=d_ex)
    _, out_s, state = st.step(x0, data_batch=data)
    iters = out_s.num_iters.clone()
    for _ in range(o3.max_iters):
        _, out_s, state = st.step(state=state, data_batch=data)
        iters += out_s.num_iters
    running = out_s.stop_reason == int(to.StopReason.MAX_ITERS)
    xs = torch.where(running[:, None], state.best_x, state.x)
    assert torch.equal(xs, ref3[0]), "Stepper: x"
    assert torch.equal(out_s.stop_reason, ref3[1].stop_reason), "Stepper"
    assert torch.equal(iters, ref3[1].num_iters), "Stepper: iterations"
    log("[segments] Stepper: 4 steps equal a solve with max_iters=3 "
        "(x, stop reasons, iterations)")
    # the timeout loop on one bench instance
    d0 = type(data)(*(a[0] for a in data))

    def one(x):
        return prior_residual(x, d0)
    o1 = bench_options(to, "cg")
    plain = to.optimize(x0[0], one, o1)
    tiny = to.optimize(x0[0], one, o1.replace(max_duration_ms=1e-6))
    assert int(tiny[1].stop_reason) == int(to.StopReason.TIMED_OUT)
    assert int(tiny[1].num_iters) == 1 and torch.equal(tiny[0], x0[0]), \
        "timeout: x is the best point after one iteration"
    generous = to.optimize(x0[0], one, o1.replace(max_duration_ms=1e6))
    assert torch.equal(generous[0], plain[0]), "timeout: generous budget"
    assert int(generous[1].stop_reason) == int(plain[1].stop_reason)
    assert int(generous[1].num_iters) == int(plain[1].num_iters)
    rec["timeout_ms"] = float(generous[1].duration_ms)
    log(f"[segments] timeout: max_duration_ms=1e-6 stops TIMED_OUT after 1 "
        f"iteration at the best point; max_duration_ms=1e6 equals the "
        f"plain solve ({int(plain[1].num_iters)} iterations, "
        f"{float(generous[1].duration_ms):.2f} ms host-stepped against "
        f"{float(plain[1].duration_ms):.2f} ms)")


def phase10(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """Covariance on the flagship: 10,000 SE3 poses x 16 points, f32."""
    from tinyopt_tpu_torch.models.se3_refinement import (make_se3_refinement,
                                                         se3_residual)
    sdata, sx0, _ = make_se3_refinement(BATCH, SE3_K, dtype=torch.float32,
                                        seed=3, device=dev)
    rec = record["covariance"] = {}
    chol = se3_options(to, "cholesky", hessian=to.HessianOptions(
        solver="cholesky", save_last=True, carry_system=True))
    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    cuda_solver.fused_solve.warp_launches = 0
    xc, outc = to.batched_optimize(sx0, se3_residual, chol, data_batch=sdata)
    torch.cuda.synchronize()
    path_launches["cov_cholesky"] = {"K1": cuda_cg.cg_solve.launches,
                                     "K2": cuda_solver.fused_solve.launches}
    outc.covariance()                  # untimed: the solver's first call
    C, cov_ms = timed(lambda: outc.covariance())
    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    cuda_solver.fused_solve.warp_launches = 0
    xf, outf = to.batched_optimize(sx0, se3_residual, se3_options(to),
                                   data_batch=sdata)
    torch.cuda.synchronize()
    n = path_launches["cov_fused"] = {"K1": cuda_cg.cg_solve.launches,
                                      "K2": cuda_solver.fused_solve.launches}
    assert n == {"K1": 0, "K2": 1}, f"covariance, fused: launches {n}"
    to.covariance_at(se3_residual, xf, data_batch=sdata)      # untimed
    Cf, at_ms = timed(lambda: to.covariance_at(se3_residual, xf,
                                               data_batch=sdata))
    assert C.shape == Cf.shape == (BATCH, 6, 6)
    s64 = type(sdata)(*(a.double() for a in sdata))
    ref_c = to.covariance_at(se3_residual, pytree_double(xc), data_batch=s64)
    ref_f = to.covariance_at(se3_residual, pytree_double(xf), data_batch=s64)

    def rel(a, b):
        return ((a.double() - b).abs().amax(dim=(-2, -1))
                / b.abs().amax(dim=(-2, -1))).max().item()
    # limit 1e-3 relative to each instance's largest entry: H⁻¹ of a 6 x 6
    # JᵀJ in float32 (16 points, poses' lever arms ~1) and, between the two
    # solves, poses apart by their stopping tolerance
    gaps = {"cholesky_vs_f64": rel(C, ref_c),
            "at_fused_vs_f64": rel(Cf, ref_f),
            "cholesky_vs_at_fused": rel(C, Cf.double())}
    for k, v in gaps.items():
        assert v < 1e-3, f"covariance {k}: {v}"
    Cr = outc.covariance(rescaled=True)
    scale = (outc.final_cost.cost ** 2 / (3 * SE3_K - 6))[:, None, None]
    torch.testing.assert_close(Cr, C * scale, rtol=1e-6, atol=0)
    rec.update(gaps, covariance_ms=cov_ms, covariance_at_ms=at_ms,
               launches=n)
    log(f"[covariance] SE3 {SE3_CELL} f32: Output.covariance() (cholesky, "
        f"save_last) {cov_ms:.3f} ms, covariance_at at the fused (K2) "
        f"result {at_ms:.3f} ms; largest gap relative to an instance's "
        f"largest entry: {gaps}; rescaled = cost²/(48 - 6) x covariance")


def pytree_double(x):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda a: a.double(), x)


POWELL_F32_FLOOR = 1e-13


def phase11(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """multi_start_optimize (Powell from 10,000 starts through "cg": the
    loop and K1) and implicit_solver (1,000 weighted linear fits, float64,
    through "cg")."""
    from tinyopt_tpu_torch.models.problems import powell_singular_residuals
    rec = record["multi_start"] = {}
    g = torch.Generator(device=dev).manual_seed(11)
    starts = (torch.tensor(MC_STARTS["powell"], device=dev)
              + 2.0 * torch.randn((BATCH, 4), generator=g, device=dev))
    opts = to.Options(max_iters=200, max_consec_failures=0,
                      hessian=to.HessianOptions(solver="cg"))
    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    cuda_solver.fused_solve.warp_launches = 0
    (xb, ob, outs), ms = timed(lambda: to.multi_start_optimize(
        starts, powell_singular_residuals, opts))
    n = path_launches["multi_start_cg"] = {
        "K1": cuda_cg.cg_solve.launches,
        "K2": cuda_solver.fused_solve.launches}
    assert n["K1"] > 0 and n["K2"] == 0, f"multi-start: launches {n}"
    # the twin: the same starts through the same loop on the CPU, where
    # cg_solve runs K1's plain twin
    _, ob_t, outs_t = to.multi_start_optimize(starts.cpu(),
                                              powell_singular_residuals, opts)
    best, best_t = float(ob.final_cost.cost), float(ob_t.final_cost.cost)
    rec.update(ms=ms, starts_per_s=BATCH / (ms / 1e3), best_cost=best,
               twin_best_cost=best_t, launches=n,
               succeeded=outs.succeeded().float().mean().item())
    log(f"[multi-start] Powell, {BATCH} starts through cg: "
        f"{BATCH / (ms / 1e3):.1f} starts/s ({ms:.1f} ms), launches {n}; "
        f"best cost {best:.3e} (the twin's on the CPU {best_t:.3e}), "
        f"succeeded {rec['succeeded']:.4f}")
    # the selection: the lowest cost of the successful starts
    assert best == float(torch.where(
        outs.succeeded(), outs.final_cost.cost,
        torch.full_like(outs.final_cost.cost, float("inf"))).min())
    # Powell's singular point is approached linearly, and a float32 solve
    # stops where the residuals' rounding rules (this phase's two bests
    # 1.7e-14 and 7.4e-15 on an H100 80GB HBM3, 700 W): below 1e-13 either
    # best is rounding
    assert best <= max(best_t, POWELL_F32_FLOOR), \
        "multi-start best above the twin's"

    # implicit differentiation: 1,000 weighted linear fits, float64
    B, m, dd = 1000, 12, 3
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)
    A, b, target, logw = rnd(B, m, dd), rnd(B, m), rnd(B, dd), 0.3 * rnd(B, m)

    def residual(x, th):
        Ai, bi, lw = th
        return torch.exp(lw) * (Ai @ x - bi)

    iopts = to.Options(hessian=to.HessianOptions(solver="cg"))

    def make_solve(device):
        return to.implicit_solver(residual, iopts,
                                  x_example=torch.zeros(
                                      dd, device=device, dtype=torch.float64),
                                  batched=True)

    def grad_of(solve, device):
        lw = logw.to(device).clone().requires_grad_(True)
        th = (A.to(device), b.to(device), lw)
        x = solve(th, torch.zeros(B, dd, dtype=torch.float64, device=device))
        torch.sum((x - target.to(device)) ** 2).backward()
        return lw.grad

    def losses(solve, lwv, device):
        with torch.no_grad():
            xv = solve((A.to(device), b.to(device), lwv),
                       torch.zeros(B, dd, dtype=torch.float64, device=device))
        return torch.sum((xv - target.to(device)) ** 2, dim=-1)

    # the solver is built at its first call (one AD probe of an instance)
    # and reused after: that call is untimed, the timed one solves and
    # differentiates
    solve = make_solve(dev)
    grad_of(solve, dev)
    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    cuda_solver.fused_solve.warp_launches = 0
    grad, ms = timed(lambda: grad_of(solve, dev))
    n = path_launches["implicit_cg"] = {
        "K1": cuda_cg.cg_solve.launches,
        "K2": cuda_solver.fused_solve.launches}
    assert n["K1"] > 0 and n["K2"] == 0, f"implicit: launches {n}"
    eps = 1e-5
    fd = torch.stack([
        (losses(solve, logw + eps * e, dev)
         - losses(solve, logw - eps * e, dev)) / (2 * eps)
        for e in torch.eye(m, dtype=torch.float64, device=dev)], dim=-1)
    grad_cpu = grad_of(make_solve("cpu"), "cpu")
    scale = grad.abs().max().item()
    fd_gap = (grad - fd).abs().max().item() / scale
    cpu_gap = (grad.cpu() - grad_cpu).abs().max().item() / scale
    record["implicit"] = {"ms": ms, "fd_rel_gap": fd_gap,
                          "cpu_rel_gap": cpu_gap, "launches": n}
    log(f"[implicit] {B} weighted linear fits (12 x 3), float64, cg: "
        f"solve and gradient {ms:.1f} ms (solver built before), launches "
        f"{n}; gradient against central differences {fd_gap:.3e}, against "
        f"the CPU's {cpu_gap:.3e} (relative to max|g|)")
    assert fd_gap < 1e-5 and cpu_gap < 1e-5, "implicit gradient"


def phase12(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """The log and failure lines of a 3-instance LM solve (float64, cg; the
    third instance's data NaN) on the card against the same solve on the
    CPU, and a stop callback stopping both at the same iteration."""
    import contextlib
    import io
    import re

    from tinyopt_tpu_torch.models.problems import (make_prior_batch,
                                                   prior_residual)
    data, x0 = make_prior_batch(3, 4, torch.float64, seed=13, device="cpu")
    data.y[2, 0] = float("nan")
    opts = to.Options(max_iters=8, log=to.LogOptions(enable=True,
                                                     print_failure=True),
                      hessian=to.HessianOptions(solver="cg"))
    num = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?|nan|inf")

    def run(device, o):
        buf = io.StringIO()
        d = type(data)(*(a.to(device) for a in data))
        with contextlib.redirect_stdout(buf):
            x, out = to.batched_optimize(x0.to(device), prior_residual, o,
                                         data_batch=d)
        return buf.getvalue().splitlines(), out

    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    cuda_solver.fused_solve.warp_launches = 0
    lines, out = run(dev, opts)
    n = path_launches["log_cg"] = {"K1": cuda_cg.cg_solve.launches,
                                   "K2": cuda_solver.fused_solve.launches}
    assert n["K1"] > 0, f"log: launches {n}"
    lines_cpu, out_cpu = run("cpu", opts)
    assert len(lines) == len(lines_cpu) > 3, (len(lines), len(lines_cpu))
    assert sum(l.startswith("FAILURE") for l in lines) == 1
    for a, c in zip(lines, lines_cpu):
        assert num.sub("#", a) == num.sub("#", c), (a, c)
        va = [float(v) for v in num.findall(a)]
        vc = [float(v) for v in num.findall(c)]
        # printed to 2-4 significant digits: a last-digit flip is rounding
        assert all(abs(p - q) <= 1e-3 * max(abs(p), abs(q)) + 1e-300
                   or (p != p and q != q) for p, q in zip(va, vc)), (a, c)
    assert torch.equal(out.stop_reason.cpu(), out_cpu.stop_reason)
    # a stop callback: USER_STOPPED at the same iteration on both
    cb = to.Options(max_iters=20, hessian=to.HessianOptions(solver="cg"),
                    min_rerr_dec=0.0,
                    stop_callback=lambda e, dx2, g2: e < 1e-6)
    d2, x2 = make_prior_batch(3, 4, torch.float64, seed=14, device="cpu")
    got = to.batched_optimize(x2.to(dev), prior_residual, cb,
                              data_batch=type(d2)(*(a.to(dev) for a in d2)))
    ref = to.batched_optimize(x2, prior_residual, cb, data_batch=d2)
    assert bool((got[1].stop_reason == int(to.StopReason.USER_STOPPED)).all())
    assert torch.equal(got[1].stop_reason.cpu(), ref[1].stop_reason)
    assert torch.equal(got[1].num_iters.cpu(), ref[1].num_iters)
    record["log"] = {"lines": len(lines), "launches": n,
                     "callback_iters": got[1].num_iters.tolist()}
    for line in lines:
        log(f"[log] {line}")
    log(f"[log] {len(lines)} lines on the card, the CPU's count and fields; "
        f"stop_callback: USER_STOPPED at iterations "
        f"{got[1].num_iters.tolist()} on both")


# ---- phases 13-15: the sparse solves, ICP and SEn3 (ROADMAP Queue 1,
# items 12 and 13) ----

SPARSE_DIMS = (10, 100, 1000)
SPARSE_REPS = 3
N_CPU = 256                  # instances held to the CPU port
CHAIN_B = 1000
COV_B, COV_D = 256, 50
BIG_D = 100_000


def sparse_bench_options(to, cg_iters=0, **kw):
    """bench_sparse's options (benchmarks/run_benchmarks.py:165-223)."""
    return to.Options(**{**dict(
        max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
        min_step_norm2=1e-16, max_consec_failures=3, save_history=False,
        hessian=to.HessianOptions(save_last=False, carry_system=False,
                                  cg_iters=cg_iters)), **kw})


def sparse_solvers(to, fn, x_example, opts, path):
    """``solve(x0 (B, n)) -> (x, Output)`` of ``fn`` (one instance's
    residuals of flat (n,) parameters) through the "block" (bs = 1),
    "coo" or "matfree" system and ``optimize_from_acc`` on a batch — the
    port's counterpart of the JAX bench's vmap of ``optimize_from_acc``;
    the structure of "coo" is probed on the host."""
    import dataclasses
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch import sparse
    from tinyopt_tpu_torch.ops.coloring import probe_structure
    from tinyopt_tpu_torch.optimizers.loop import optimize_from_acc
    propose = {}
    if path == "block":
        x_example = x_example[:, None]
        acc, ev, _ = sparse.block_nlls_system(fn, x_example)
    elif path == "coo":
        spec = mf.tangent_spec(x_example)
        n = x_example.shape[0]
        n_res = fn(x_example.cpu()).numel()
        structure = probe_structure(fn, x_example.cpu(), None, spec, n_res,
                                    n)
        acc, ev, _ = sparse.sparse_system(fn, x_example, spec, structure)
    else:
        spec = mf.tangent_spec(x_example)
        acc, ev, _, propose["propose"] = sparse.matfree_system(
            fn, x_example, spec, opts.hessian.cg_iters or spec.dims, 1e-10)
        opts = opts.replace(hessian=dataclasses.replace(
            opts.hessian, save_last=False))
    spec = mf.tangent_spec(x_example)
    return lambda x0: optimize_from_acc(x0, acc, ev, opts, spec, **propose)


def chain_residual(x):
    """tests/test_sparse.py:136-149's coupled chain: a tridiagonal JᵀJ,
    zero at x*_i = 0.7^(2^i)."""
    return torch.cat([3.0 * (x[1:] - x[:-1] * x[:-1]),
                      (x[0] - 0.7).reshape(1)])


# The chain's starts lie in the basin of x*: x* + 0.1 * U(-1, 1).  From
# U(0.3, 0.8) instead, most chains head for the x_i -> 1 branch, where J's
# ratio of off-diagonal to diagonal is 2 and the condition of JᵀJ grows
# like 4^d: the dense float32 solve stops in local minima there, and the
# JAX package's float32 sparse path ends SOLVER_FAILED, as the port's does
# (PERF.md §6).


def chain_starts(gen, B, d, dev):
    x_star = 0.7 ** (2.0 ** torch.arange(d, dtype=torch.float64))
    u = torch.rand((B, d), generator=gen, device=dev)
    return x_star.to(device=dev, dtype=torch.float32) + 0.1 * (2 * u - 1)


def phase13(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """The sparse solves: the reference's sparse benchmark (r = 10x − 2 at
    dims 10, 100, 1000, 10,000 instances, float32) through the block, COO
    and matrix-free paths, timed; the coupled chain with LM and DogLeg
    through COO and matrix-free against the dense solve (d = 100) and each
    other (d = 1000); BlockDiag and SparseSym covariances against float64
    inverses.  No TPU kernel is on these paths: launches must read 0."""
    rec = record["sparse"] = {}
    gen = torch.Generator(device=dev).manual_seed(13)

    def starts(B, d, lo=-1.0, hi=1.0):
        return torch.rand((B, d), generator=gen, device=dev) * (hi - lo) + lo

    def bench_fn(x):
        return 10.0 * x - 2.0

    for d in SPARSE_DIMS:
        for path in ("block", "coo", "matfree"):
            key = f"sparse_{path}_{d}"
            opts = sparse_bench_options(to, 0 if path == "block" else 8)
            x_ex = torch.zeros(d, device=dev)
            solve = sparse_solvers(to, bench_fn, x_ex, opts, path)
            x0 = starts(BATCH, d)
            cuda_cg.cg_solve.launches = 0
            cuda_solver.fused_solve.launches = 0
            cuda_solver.fused_solve.warp_launches = 0
            x, out = solve(x0)                       # warm-up and the hold
            torch.cuda.synchronize()
            n = path_launches[key] = {"K1": cuda_cg.cg_solve.launches,
                                      "K2": cuda_solver.fused_solve.launches}
            assert n == {"K1": 0, "K2": 0}, f"{key}: launches {n}"
            err = (x - 0.2).abs().max().item()
            cpu_solve = sparse_solvers(to, bench_fn, x_ex.cpu(), opts, path)
            _, out_cpu = cpu_solve(x0[:N_CPU].cpu())
            same = (out.stop_reason[:N_CPU].cpu()
                    == out_cpu.stop_reason).float().mean().item()
            times = []
            for _ in range(SPARSE_REPS):
                x_rep = starts(BATCH, d)
                _, ms = timed(lambda: solve(x_rep))
                times.append(ms)
            stops = torch.bincount(out.stop_reason.clamp(min=0),
                                   minlength=8).tolist()
            r = rec[key] = {
                "ms": times, "solves_per_s": SPARSE_REPS * BATCH
                / (sum(times) / 1e3), "max_abs_err": err, "stops": stops,
                "mean_iters": out.num_iters.float().mean().item(),
                "stops_equal_cpu_share": same}
            log(f"[sparse] {path} d={d}: {r['solves_per_s']:.1f} solves/s "
                f"({SPARSE_REPS} reps x {BATCH}, ms {times}), max|x - 0.2| "
                f"= {err:.3e}, mean iters {r['mean_iters']:.2f}, stops "
                f"{stops}, stop reasons equal to the CPU port's on the "
                f"first {N_CPU}: {same:.4f}")
            assert err < 1e-5, f"{key}: max|x - 0.2| = {err}"
            assert same == 1.0, f"{key}: stop reasons part from the CPU's"

    # the coupled chain, float32
    for d in (100, 1000):
        x0 = chain_starts(gen, CHAIN_B, d, dev)
        x_ex = torch.zeros(d, device=dev)
        for st in ("lm", "dogleg"):
            opts = to.Options(
                max_iters=100, max_consec_failures=0,
                solver_type={"lm": to.LevenbergMarquardt,
                             "dogleg": to.DogLeg}[st],
                hessian=to.HessianOptions(save_last=False))
            xs = {}
            for path in ("coo", "matfree"):
                key = f"chain_{path}_{st}_{d}"
                solve = sparse_solvers(to, chain_residual, x_ex, opts, path)
                cuda_cg.cg_solve.launches = 0
                cuda_solver.fused_solve.launches = 0
                cuda_solver.fused_solve.warp_launches = 0
                (x, out), ms = timed(lambda: solve(x0))
                n = path_launches[key] = {
                    "K1": cuda_cg.cg_solve.launches,
                    "K2": cuda_solver.fused_solve.launches}
                assert n == {"K1": 0, "K2": 0}, f"{key}: launches {n}"
                assert bool(torch.all(torch.isfinite(x))), key
                assert bool(torch.all(out.converged())), key
                xs[path] = x
                rec[key] = {"ms": ms, "solves_per_s": CHAIN_B / (ms / 1e3),
                            "conv": out.converged().float().mean().item(),
                            "mean_iters": out.num_iters.float().mean().item()}
                log(f"[sparse] chain d={d} {st} {path}: "
                    f"{rec[key]['solves_per_s']:.1f} solves/s ({CHAIN_B} "
                    f"chains, {ms:.1f} ms), conv {rec[key]['conv']:.4f}, "
                    f"mean iters {rec[key]['mean_iters']:.2f}")
            if d == 100:
                xd, _ = to.batched_optimize(
                    x0, chain_residual, opts.replace(
                        hessian=to.HessianOptions(solver="cholesky")))
                for path, x in xs.items():
                    gap = (x - xd).abs().max().item()
                    rec[f"chain_{path}_{st}_{d}"]["max_abs_to_dense"] = gap
                    log(f"[sparse] chain d={d} {st} {path}: max|x - x_dense|"
                        f" = {gap:.3e}")
                    assert gap < 1e-4, f"chain {path} {st}: {gap} from dense"
            else:
                gap = (xs["coo"] - xs["matfree"]).abs().max().item()
                rec[f"chain_coo_{st}_{d}"]["max_abs_to_matfree"] = gap
                log(f"[sparse] chain d={d} {st}: max|x_coo - x_matfree| = "
                    f"{gap:.3e}")
                assert gap < 1e-4, f"chain d=1000 {st}: coo vs matfree {gap}"

    # the default carry (carry_system=True) at d = 100,000, one instance:
    # a dense carried H would take 40 GB in float32; the loop carries what
    # the first build makes (a BlockDiag, the linearization point)
    for path in ("block", "matfree"):
        x0 = starts(1, BIG_D)[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if path == "block":
            x, out = to.block_optimize(x0[:, None], bench_fn,
                                       to.Options(max_iters=10))
        else:
            x, out = to.matfree_optimize(x0, bench_fn,
                                         to.Options(max_iters=10),
                                         cg_iters=8)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        err = (x - 0.2).abs().max().item()
        rec[f"big_{path}"] = {"d": BIG_D, "peak_gb": peak, "max_abs_err": err}
        log(f"[sparse] {path} at d={BIG_D}, default carry: peak memory "
            f"{peak:.4f} GB, max|x - 0.2| = {err:.3e}")
        assert peak < 1.0 and err < 1e-5, f"{path} at d={BIG_D}"

    # covariances at 256 x 50 against float64 inverses at the same x
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch import sparse
    from tinyopt_tpu_torch.ops.coloring import probe_structure
    from tinyopt_tpu_torch.optimizers.loop import optimize_from_acc
    opts = to.Options(max_iters=50, max_consec_failures=0)
    nb = COV_D // 2
    tgt = starts(COV_B, COV_D, 0.5, 2.0).reshape(COV_B, nb, 2)

    def blk(xb, t):
        return torch.stack([xb[0] + 0.5 * xb[1], xb[1] * xb[1]]) - t

    def cov_gap(C, C64):
        return ((C.double() - C64).abs().amax(dim=(-2, -1))
                / C64.abs().amax(dim=(-2, -1))).max().item()

    x_ex = torch.ones((nb, 2), device=dev)
    spec = mf.tangent_spec(x_ex)
    acc, ev, _ = sparse.block_nlls_system(blk, x_ex, tgt)
    x, out = optimize_from_acc(torch.ones((COV_B, COV_D), device=dev), acc,
                               ev, opts, spec)
    acc64, _, _ = sparse.block_nlls_system(blk, x_ex.double(), tgt.double())
    C64 = torch.linalg.inv(acc64(x.double())[0].to_dense())
    gap_blk = cov_gap(out.covariance(), C64)
    x_ex = torch.zeros(COV_D, device=dev)
    spec = mf.tangent_spec(x_ex)
    structure = probe_structure(chain_residual, x_ex.cpu(), None, spec,
                                COV_D, COV_D)
    acc, ev, _ = sparse.sparse_system(chain_residual, x_ex, spec, structure)
    x, out2 = optimize_from_acc(chain_starts(gen, COV_B, COV_D, dev), acc,
                                ev, opts, spec)
    acc64, _, _ = sparse.sparse_system(chain_residual, x_ex.double(),
                                       mf.tangent_spec(x_ex.double()),
                                       structure)
    C64 = torch.linalg.inv(acc64(x.double())[0].to_dense())
    gap_coo = cov_gap(out2.covariance(), C64)
    rec["covariance"] = {"block_max_rel_gap": gap_blk,
                         "coo_max_rel_gap": gap_coo}
    log(f"[sparse] covariance {COV_B} x {COV_D} float32 against float64 "
        f"H^-1 (relative to each instance's largest entry): BlockDiag "
        f"{gap_blk:.3e}, SparseSym {gap_coo:.3e}")
    assert bool(torch.all(out.converged())) and bool(
        torch.all(out2.converged())), "covariance solves"
    assert gap_blk < 1e-3 and gap_coo < 1e-3, "sparse covariance"


ICP_B, ICP_SCAN_B, ICP_SCAN_N = 4096, 8, 10_000


#: phase 14's timed calls after the first, fresh pairs each (2 until the
#: script neared its time limit)
ICP_REPS = 1


def icp_options(to, solver="cholesky"):
    """``models.icp.icp``'s default options, with the inner solver."""
    return to.Options(max_iters=8, max_consec_failures=0,
                      hessian=to.HessianOptions(solver=solver))


def icp_pose_errors(pose, true_pose):
    """Per pair: ‖log(T · T_true⁻¹)‖."""
    return torch.linalg.vector_norm((pose @ true_pose.inverse()).log(),
                                    dim=-1)


def phase14(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """ICP: 4,096 pairs of make_icp_problem's defaults (128 -> 160 points,
    float32, 10 alternations) through "cholesky" and "cg" (K1 at
    (4096, 6, 6), counted), held to the true poses and, on the first 64
    pairs, to the CPU port's poses; the scan-sized case (8 pairs of
    10,000 -> 10,000 points); robust ICP with 15 % outliers against plain
    least squares; K1 timed at (4096, 6, 6)."""
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch.manifolds import SE3
    from tinyopt_tpu_torch.models.icp import icp, make_icp_problem
    from tinyopt_tpu_torch.ops.linalg import solve_psd_cg
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    rec = record["icp"] = {}
    prob = make_icp_problem(ICP_B, seed=14, device=dev)
    n_cpu = 64
    for solver in ("cholesky", "cg"):
        key = f"icp_{solver}"
        opts = icp_options(to, solver)
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        (pose, out), ms = timed(lambda: icp(prob.src, prob.dst,
                                            options=opts))
        n = path_launches[key] = {"K1": cuda_cg.cg_solve.launches,
                                  "K2": cuda_solver.fused_solve.launches}
        assert n["K2"] == 0, f"{key}: launches {n}"
        assert (n["K1"] > 0) == (solver == "cg"), f"{key}: launches {n}"
        errs = icp_pose_errors(pose, prob.true_pose)
        ok_share = (errs < 1e-3).float().mean().item()
        ref, _ = icp(prob.src[:n_cpu].cpu(), prob.dst[:n_cpu].cpu(),
                     options=opts)
        gap = max((pose.rotation.wxyz[:n_cpu].cpu()
                   - ref.rotation.wxyz).abs().max().item(),
                  (pose.translation[:n_cpu].cpu()
                   - ref.translation).abs().max().item())
        times = []
        for rep in range(ICP_REPS):
            p_rep = make_icp_problem(ICP_B, seed=1400 + rep, device=dev)
            _, t = timed(lambda: icp(p_rep.src, p_rep.dst, options=opts))
            times.append(t)
        r = rec[key] = {
            "ms": [ms] + times,
            "pairs_per_s": len(times) * ICP_B / (sum(times) / 1e3),
            "share_within_1e-3": ok_share,
            "median_pose_err": errs.median().item(),
            "max_pose_err": errs.max().item(),
            "max_abs_to_cpu_first_64": gap, "launches": n}
        log(f"[icp] {ICP_B} pairs 128 -> 160 {solver}: {r['pairs_per_s']:.1f}"
            f" pairs/s ({ICP_REPS} rep, ms {times}; first call {ms:.1f} ms), pose "
            f"error median {r['median_pose_err']:.3e} max "
            f"{r['max_pose_err']:.3e}, within 1e-3 of the true pose: "
            f"{ok_share:.4f}; first {n_cpu} pairs against the CPU port: max "
            f"gap {gap:.3e}; launches {n}")
        assert bool(torch.all(torch.isfinite(pose.translation)))
        assert gap < 1e-4, f"{key}: {gap} from the CPU port"
        # identity-start ICP is non-convex: the JAX package's docstring
        # measured 491 of 512 random 0.3-scale poses registering
        assert ok_share > 0.9, f"{key}: {ok_share} of the pairs registered"

    # the scan-sized case of the module docstring: 8 pairs of 10,000 points
    # (uniform clouds this dense leave identity-start ICP far from the
    # true pose after 10 alternations, so the errors are printed).  The
    # pairs are drawn on the CPU, so that the first is the one
    # tests/test_torch_icp.py::TestICP::test_scan_sized_pair_matches_reference
    # holds the CPU port to the JAX package on (float64, 1e-6; neither
    # registers it); here the card is held to the CPU port on that pair in
    # float64.  In float32 among 10,000 candidates a point, near-ties flip
    # a few correspondences between the card's cross term and the CPU's.
    scan = pytree.tree_map(lambda a: a.to(dev), make_icp_problem(
        ICP_SCAN_B, ICP_SCAN_N, ICP_SCAN_N, seed=15, device="cpu"))
    torch.cuda.reset_peak_memory_stats()
    (pose, out), ms = timed(lambda: icp(scan.src, scan.dst))
    errs = icp_pose_errors(pose, scan.true_pose)
    errs0 = icp_pose_errors(SE3.identity(torch.float32, (ICP_SCAN_B,), dev),
                            scan.true_pose)
    one = (scan.src[:1].double(), scan.dst[:1].double())
    got, _ = icp(*one)
    ref, _ = icp(*(a.cpu() for a in one))
    gap = max((got.rotation.wxyz.cpu() - ref.rotation.wxyz).abs().max(
        ).item(), (got.translation.cpu() - ref.translation).abs().max(
        ).item())
    rec["scan"] = {"ms": ms, "pairs_per_s": ICP_SCAN_B / (ms / 1e3),
                   "pose_errs": errs.tolist(),
                   "start_pose_errs": errs0.tolist(),
                   "f64_max_abs_to_cpu_first": gap,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[icp] scan {ICP_SCAN_B} pairs of {ICP_SCAN_N} -> {ICP_SCAN_N}: "
        f"{rec['scan']['pairs_per_s']:.2f} pairs/s ({ms:.1f} ms), pose "
        f"errors {[f'{e:.2e}' for e in errs.tolist()]} (from "
        f"{[f'{e:.2e}' for e in errs0.tolist()]} at the identity), peak "
        f"memory {rec['scan']['peak_gb']:.2f} GB; first pair in float64 "
        f"against the CPU port: max gap {gap:.3e}")
    assert bool(torch.all(torch.isfinite(errs))), "scan ICP"
    assert gap < 1e-6, f"scan ICP: {gap} from the CPU port (float64)"

    # robust ICP under 15 % outliers against plain least squares
    noisy = make_icp_problem(256, 96, 128, outlier_frac=0.15, seed=16,
                             device=dev)
    pose_r, _ = icp(noisy.src, noisy.dst, n_outer=15, robust_th=0.1)
    pose_p, _ = icp(noisy.src, noisy.dst, n_outer=15)
    med_r = icp_pose_errors(pose_r, noisy.true_pose).median().item()
    med_p = icp_pose_errors(pose_p, noisy.true_pose).median().item()
    rec["robust"] = {"median_err_huber": med_r, "median_err_plain": med_p}
    log(f"[icp] 256 pairs, 15 % outliers: median pose error Huber "
        f"{med_r:.3e}, least squares {med_p:.3e}")
    assert med_r < 0.02 and med_r < med_p / 10, "robust ICP"

    # K1 at the ICP "cg" path's shape: (4096, 6, 6), 6 iterations
    g = torch.Generator(device=dev).manual_seed(17)
    A = torch.randn((ICP_B, 12, 6), generator=g, device=dev) / 12 ** 0.5
    H = A.mT @ A + 1e-3 * torch.eye(6, device=dev)
    b = torch.randn((ICP_B, 6), generator=g, device=dev)
    xt = solve_psd_cg(H, b, 6)
    err = (cuda_cg.cg_solve(H, b, 6) - xt).abs().max().item()
    scale = xt.abs().max().item()
    k1 = rec["k1"] = {
        "max_abs_err": err, "max_abs_x": scale,
        "ms": gpu_ms(lambda: cuda_cg.cg_solve(H, b, 6), n=20),
        "plain_ms": gpu_ms(lambda: solve_psd_cg(H, b, 6), n=5),
        "launches": path_launches["icp_cg"]["K1"]}
    k1["bound_ms"], k1["bound_by"] = k1_bound(ICP_B, 6, 6, 4)
    log(f"[icp] K1 at ({ICP_B}, 6, 6), 6 iterations: kernel {k1['ms']:.4f} "
        f"ms, twin {k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
        f"({k1['bound_by']}), max|x_k - x_twin| {err:.3e} (max|x| "
        f"{scale:.3e}); {k1['launches']} launches on the cg path")
    # phase 3's hold of K1 in float32: 1e-5 of max|x| (H = AᵀA + 1e-3 I
    # may be ill-conditioned, so the error scales with x, not absolutely)
    assert err <= 1e-5 * max(1.0, scale), "K1 at (4096, 6, 6)"


def phase15(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """SEn3⟨3⟩: prior solves of 10,000 instances on the card (float32),
    held to the CPU port's on the first 256."""
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch.manifolds import SEn3
    g = torch.Generator(device=dev).manual_seed(18)
    w = torch.rand((BATCH, 12), generator=g, device=dev) * 1.6 - 0.8
    prior = SEn3.exp(w)

    def res(x, p):
        return (p @ x).log()

    x0 = SEn3.identity(3, torch.float32, (BATCH,), dev)
    opts = to.Options()
    # the first call pays one-time work (~3 s on a CPU); timed apart
    _, cold_ms = timed(lambda: to.batched_optimize(x0, res, opts,
                                                   data_batch=prior))
    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    cuda_solver.fused_solve.warp_launches = 0
    (x, out), ms = timed(lambda: to.batched_optimize(x0, res, opts,
                                                     data_batch=prior))
    n = path_launches["sen3"] = {"K1": cuda_cg.cg_solve.launches,
                                 "K2": cuda_solver.fused_solve.launches}
    assert n == {"K1": 0, "K2": 0}, f"sen3: launches {n}"
    first = pytree.tree_map(lambda a: a[:N_CPU].cpu(), (x0, prior))
    xc, outc = to.batched_optimize(first[0], res, opts, data_batch=first[1])
    gap = max((x.rotation.wxyz[:N_CPU].cpu() - xc.rotation.wxyz).abs().max(
        ).item(), (x.vectors[:N_CPU].cpu() - xc.vectors).abs().max().item())
    di = (out.num_iters[:N_CPU].cpu() - outc.num_iters).abs().max().item()
    resid = torch.linalg.vector_norm(res(x, prior), dim=-1).max().item()
    record["sen3"] = {"ms": ms, "solves_per_s": BATCH / (ms / 1e3),
                      "first_call_ms": cold_ms,
                      "conv": out.converged().float().mean().item(),
                      "max_abs_to_cpu": gap, "iter_gap": di,
                      "max_residual": resid}
    log(f"[sen3] SEn3<3> prior, {BATCH} instances: "
        f"{record['sen3']['solves_per_s']:.1f} solves/s ({ms:.1f} ms; the "
        f"first call {cold_ms:.1f} ms), conv "
        f"{record['sen3']['conv']:.4f}, max |log(prior x)| {resid:.3e}; "
        f"first {N_CPU} against the CPU port: max gap {gap:.3e}, iteration "
        f"gap {di}")
    assert bool(torch.all(out.converged())), "sen3 convergence"
    assert gap < 1e-4 and di <= 1, "sen3 against the CPU port"


# ---- phase 16: Schur-complement bundle adjustment (slice C item 14) ----

BA_CAMS, BA_PTS, BA_NOISE = 100, 5000, 1e-3   # bench_ba's problem
BA_CRIT = 1.2e-3             # bench_ba's criterion: RMSE <= 1.2 x the noise
BA_BATCH = 1000              # 16c: instances of 4 cameras x 24 points
BA_SMALL = (4, 24)


def ba_pair(pose, point, obs):
    """One observation's reprojection residual (the pair form of
    ``ba_residuals``, benchmarks/run_benchmarks.py:315-316)."""
    from tinyopt_tpu_torch.models.bundle_adjustment import project
    return project(pose, point[None, :])[0] - obs


def ba_pair_prior(pose, point, obs):
    """``ba_pair`` with a prior of weight 0.1 on the pose's log and the
    point in every pair: BA's 7-dim gauge leaves the plain H singular, so
    its covariance is rounding noise; the prior makes H positive
    definite."""
    return torch.cat([ba_pair(pose, point, obs), 0.1 * pose.log(),
                      0.1 * point])


def ba_launches(path_launches, key, cuda_cg, cuda_solver):
    n = path_launches[key] = {"K1": cuda_cg.cg_solve.launches,
                              "K2": cuda_solver.fused_solve.launches}
    return n


def phase16(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """Schur-complement bundle adjustment (slice C item 14).  16a:
    bench_ba's 100 cameras x 5,000 landmarks (15,600 tangent dims,
    float32, benchmarks/run_benchmarks.py:264-326) through schur_optimize
    with LM, the dogleg, LM with schur_refine=2 and LM with
    schur_cg_iters=32, each to bench_ba's criterion, timed after a warm-up
    from a perturbed start; no TPU kernel is on these paths.  16b: the
    card against the CPU port in float64 (GN, LM, the dogleg; a
    covariance at 10 x 200).  16c: 1,000 small BA problems through the
    batched Schur system, the dense loop with "cholesky", and with "cg"
    (K1's cg_block_kernel at (1000, 96, 96), counted and timed)."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.models.bundle_adjustment import (
        ba_residuals, make_ba_problem, reprojection_rmse)
    from tinyopt_tpu_torch.ops.linalg import solve_psd_cg
    from tinyopt_tpu_torch.ops.schur import schur_system
    from tinyopt_tpu_torch.optimizers.loop import optimize_from_acc
    # float32 products must be exact (PARITY.md:121: a lower-precision
    # multiply stalls BA at RMSE 3.2e-3)
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    rec = record["ba"] = {}

    # ---- 16a: the large BA ----
    data, x0, _ = make_ba_problem(n_cams=BA_CAMS, n_pts=BA_PTS,
                                  noise=BA_NOISE, seed=11,
                                  dtype=torch.float32, device=dev)
    base = to.Options(max_iters=12, max_consec_failures=0, min_error=0.0,
                      hessian=to.HessianOptions(save_last=False)
                      ).for_dtype(torch.float32)
    variants = {
        "lm": base,
        "dogleg": dataclasses.replace(base, solver_type=to.DogLeg),
        "lm_refine2": dataclasses.replace(base, hessian=dataclasses.replace(
            base.hessian, schur_refine=2)),
        "lm_cg32": dataclasses.replace(
            base, max_iters=24, hessian=dataclasses.replace(
                base.hessian, schur_cg_iters=32)),
    }
    dims = 6 * BA_CAMS + 3 * BA_PTS
    warm_x0 = dict(x0, points=x0["points"] + 1e-3)
    rmse0 = reprojection_rmse(x0, data).item()
    for name, o in variants.items():
        def run(x):
            return to.schur_optimize((x["poses"], x["points"]), ba_pair,
                                     data.observations, data.mask, o)
        run(warm_x0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        t0 = time.perf_counter()
        (poses, points), out = run(x0)
        rmse = reprojection_rmse({"points": points, "poses": poses},
                                 data).item()
        wall = time.perf_counter() - t0
        n = ba_launches(path_launches, f"ba_{name}", cuda_cg, cuda_solver)
        iters = int(out.num_iters)
        r = rec[name] = {
            "wall_s": wall, "iters": iters,
            "ms_per_iter": wall * 1e3 / max(iters, 1),
            "rmse": rmse, "rmse0": rmse0,
            "stop": int(out.stop_reason),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": n}
        log(f"[ba] {BA_CAMS} cams x {BA_PTS} pts ({dims} dims) {name}: "
            f"{wall:.3f} s, {iters} iterations ({r['ms_per_iter']:.1f} ms "
            f"an iteration), RMSE {rmse0:.3e} -> {rmse:.4e} (criterion "
            f"{BA_CRIT}), stop {r['stop']}, peak memory {r['peak_gb']:.2f}"
            f" GB, launches {n}")
        assert n == {"K1": 0, "K2": 0}, f"ba_{name}: launches {n}"
        assert rmse <= BA_CRIT, f"ba_{name}: RMSE {rmse}"

    # ---- 16b: the card against the CPU port, float64 ----
    cmp = rec["f64_vs_cpu"] = {}
    d64, x64, _ = make_ba_problem(n_cams=6, n_pts=64, noise=1e-4, seed=9,
                                  device="cpu")

    def both(x, d, pair, o):
        outs = []
        for where in (dev, "cpu"):
            xx = pytree.tree_map(lambda a: a.to(where), x)
            dd = pytree.tree_map(lambda a: a.to(where), d)
            outs.append(to.schur_optimize((xx["poses"], xx["points"]), pair,
                                          dd.observations, dd.mask, o))
        return outs

    for name, st in (("gn", to.GaussNewton), ("lm", to.LevenbergMarquardt),
                     ("dogleg", to.DogLeg)):
        o = to.Options(max_iters=15, max_consec_failures=0, solver_type=st)
        (xg, og), (xc, oc) = both(x64, d64, ba_pair, o)
        gap = max(((a.cpu() - b).abs().max() / b.abs().max().clamp(
            min=1e-300)).item() for a, b in zip(pytree.tree_leaves(xg),
                                                 pytree.tree_leaves(xc)))
        cg_, cc = og.final_cost.cost.item(), oc.final_cost.cost.item()
        # equal costs (inf included: GN stops before it accepts a step)
        cost_gap = 0.0 if cg_ == cc else abs(cg_ - cc) / abs(cc)
        cmp[name] = {"stop": [int(og.stop_reason), int(oc.stop_reason)],
                     "iters": [int(og.num_iters), int(oc.num_iters)],
                     "x_rel_gap": gap, "cost_rel_gap": cost_gap}
        log(f"[ba] 6 x 64 float64 {name}: card / CPU stop "
            f"{cmp[name]['stop']}, iterations {cmp[name]['iters']}, x "
            f"relative gap {gap:.3e}, cost relative gap {cost_gap:.3e}")
        assert cmp[name]["stop"][0] == cmp[name]["stop"][1], name
        assert cmp[name]["iters"][0] == cmp[name]["iters"][1], name
        assert gap <= 1e-9 and cost_gap <= 1e-9, name
    d10, x10, _ = make_ba_problem(n_cams=10, n_pts=200, noise=1e-3, seed=7,
                                  device="cpu")
    o = to.Options(max_iters=40, max_consec_failures=0, min_error=0.0)
    (xg, og), (xc, oc) = both(x10, d10, ba_pair_prior, o)
    covg, covc = og.covariance().cpu(), oc.covariance()
    cov_gap = ((covg - covc).abs().max() / covc.abs().max()).item()
    cmp["cov_10x200"] = {"dims": covc.shape[-1], "rel_gap": cov_gap,
                         "iters": [int(og.num_iters), int(oc.num_iters)],
                         "finite": bool(torch.isfinite(covg).all())}
    log(f"[ba] 10 x 200 float64 with a 0.1 prior: covariance "
        f"{tuple(covc.shape)}, card against the CPU port: relative gap "
        f"{cov_gap:.3e}, iterations {cmp['cov_10x200']['iters']}")
    assert cmp["cov_10x200"]["finite"] and cov_gap <= 1e-9, "covariance"

    # ---- 16c: 1,000 small problems, batched ----
    probs = [make_ba_problem(*BA_SMALL, noise=BA_NOISE, seed=i,
                             dtype=torch.float32, device="cpu")
             for i in range(BA_BATCH)]

    def stack(f):
        return pytree.tree_map(lambda *a: torch.stack(a).to(dev),
                               *[f(p) for p in probs])

    bdata = stack(lambda p: p[0])
    bx0 = stack(lambda p: p[1])
    nb_dims = 6 * BA_SMALL[0] + 3 * BA_SMALL[1]
    opts = to.Options(max_iters=20, max_consec_failures=0).for_dtype(
        torch.float32)
    batch = {}

    # the Schur system on the whole batch
    one = pytree.tree_map(lambda a: a[0], bx0)
    spec = mf.tangent_spec((one["poses"], one["points"]))
    acc, ev, _, prop = schur_system(ba_pair, one["poses"], one["points"],
                                    bdata.observations, bdata.mask, spec)
    xb = mf.flatten_batch((bx0["poses"], bx0["points"]), spec)
    cuda_cg.cg_solve.launches = 0
    cuda_solver.fused_solve.launches = 0
    cuda_solver.fused_solve.warp_launches = 0
    (x, out), ms = timed(lambda: optimize_from_acc(xb, acc, ev, opts, spec,
                                                   propose=prop))
    n = ba_launches(path_launches, "ba_batch_schur", cuda_cg, cuda_solver)
    poses, points = mf.unflatten(x, spec)
    batch["schur"] = ({"points": points, "poses": poses}, out, ms, n)
    for solver in ("cholesky", "cg"):
        o = dataclasses.replace(opts, hessian=dataclasses.replace(
            opts.hessian, solver=solver))
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        (xs, out), ms = timed(lambda: to.batched_optimize(
            bx0, ba_residuals, o, data_batch=bdata))
        n = ba_launches(path_launches, f"ba_batch_{solver}", cuda_cg,
                        cuda_solver)
        batch[solver] = (xs, out, ms, n)

    def rmse_each(xs):
        return torch.func.vmap(reprojection_rmse)(xs, bdata)

    crec = rec["batch"] = {}
    for name, (xs, out, ms, n) in batch.items():
        r = rmse_each(xs)
        crec[name] = {"ms": ms, "solves_per_s": BA_BATCH / (ms / 1e3),
                      "share_at_criterion": (r <= BA_CRIT).float().mean(
                          ).item(),
                      "median_rmse": r.median().item(),
                      "mean_iters": out.num_iters.float().mean().item(),
                      "conv": out.converged().float().mean().item(),
                      "launches": n}
        log(f"[ba] {BA_BATCH} x ({BA_SMALL[0]} cams x {BA_SMALL[1]} pts, "
            f"{nb_dims} dims) {name}: {crec[name]['solves_per_s']:.1f} "
            f"solves/s ({ms:.1f} ms), RMSE <= {BA_CRIT} on "
            f"{crec[name]['share_at_criterion']:.4f} (median "
            f"{crec[name]['median_rmse']:.3e}), iterations mean "
            f"{crec[name]['mean_iters']:.2f}, conv {crec[name]['conv']:.4f}"
            f", launches {n}")
    assert batch["schur"][3] == {"K1": 0, "K2": 0}, "ba_batch_schur"
    assert batch["cholesky"][3] == {"K1": 0, "K2": 0}, "ba_batch_cholesky"
    assert batch["cg"][3]["K1"] > 0 and batch["cg"][3]["K2"] == 0, \
        f"ba_batch_cg: launches {batch['cg'][3]}"
    assert (crec["cg"]["share_at_criterion"]
            >= crec["cholesky"]["share_at_criterion"]), "ba cg criterion"
    # float32: the Schur and dense solves of one instance part at the noise
    # floor (the gauge drifts by rounding, and the stop tests fire an
    # iteration apart; a CPU rehearsal of 64 instances: RMSE within 6.3e-6
    # relative, x within 9.2e-4, iterations up to 8 apart), so their
    # RMSEs are held to 1e-4 relative here and the trajectories in float64
    r_s, r_c = rmse_each(batch["schur"][0]), rmse_each(batch["cholesky"][0])
    crec["schur_vs_cholesky_f32"] = {
        "rmse_rel_gap": ((r_s - r_c).abs() / r_c).max().item(),
        "iter_gap": (batch["schur"][1].num_iters
                     - batch["cholesky"][1].num_iters).abs().max().item()}
    log(f"[ba] {BA_BATCH} float32: Schur against cholesky, RMSE relative "
        f"gap {crec['schur_vs_cholesky_f32']['rmse_rel_gap']:.3e}, "
        f"iteration gap {crec['schur_vs_cholesky_f32']['iter_gap']}")
    assert crec["schur_vs_cholesky_f32"]["rmse_rel_gap"] <= 1e-4
    # float64, the same instances: Schur against the dense cholesky loop
    # per instance with tests/test_fused.py:51's tolerances (x in the
    # parameter pytree; gradients in one tangent order: the Schur loop's
    # is [poses; points], the dense one's [points; poses])
    data64 = pytree.tree_map(lambda a: a.double(), bdata)
    x64_0 = pytree.tree_map(lambda a: a.double(), bx0)
    o64 = to.Options(max_iters=20, max_consec_failures=0)
    one64 = pytree.tree_map(lambda a: a.double(),
                            (one["poses"], one["points"]))
    spec64 = mf.tangent_spec(one64)
    acc, ev, _, prop = schur_system(ba_pair, one64[0], one64[1],
                                    data64.observations, data64.mask, spec64)
    x, out_s = optimize_from_acc(
        mf.flatten_batch((x64_0["poses"], x64_0["points"]), spec64), acc,
        ev, o64, spec64, propose=prop)
    poses, points = mf.unflatten(x, spec64)
    xs_c, out_c = to.batched_optimize(
        x64_0, ba_residuals, dataclasses.replace(o64, hessian=dataclasses
                                                 .replace(o64.hessian,
                                                          solver="cholesky")),
        data_batch=data64)
    xs_s = {"points": points, "poses": poses}
    for a, b in zip(pytree.tree_leaves(xs_s), pytree.tree_leaves(xs_c)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                   equal_nan=True, msg="ba schur vs dense")
    assert torch.equal(out_s.succeeded(), out_c.succeeded())
    assert torch.equal(out_s.converged(), out_c.converged())
    di = (out_s.num_iters - out_c.num_iters).abs().max().item()
    df = (out_s.num_failures - out_c.num_failures).abs().max().item()
    assert di <= 1 and df == 0, f"ba schur vs dense: gaps {di}, {df}"
    torch.testing.assert_close(out_s.final_cost.cost, out_c.final_cost.cost,
                               rtol=1e-5, atol=1e-6)
    n_pose = 6 * BA_SMALL[0]
    g_s = torch.cat([out_s.final_grad[:, n_pose:],
                     out_s.final_grad[:, :n_pose]], dim=-1)
    torch.testing.assert_close(g_s, out_c.final_grad, rtol=1e-4, atol=1e-5)
    crec["schur_vs_cholesky_f64"] = {
        "max_abs_x": max((a - b).abs().max().item() for a, b in zip(
            pytree.tree_leaves(xs_s), pytree.tree_leaves(xs_c))),
        "iter_gap": di}
    log(f"[ba] {BA_BATCH} float64: Schur against cholesky, max |x_s - x_c| "
        f"{crec['schur_vs_cholesky_f64']['max_abs_x']:.3e}, iteration gap "
        f"{di}")

    # K1 at the cg path's shape: (1000, 96, 96), 96 iterations
    g = torch.Generator(device=dev).manual_seed(19)
    k1 = rec["k1"] = {"launches": batch["cg"][3]["K1"]}
    for dtype, tag in ((torch.float32, ""), (torch.float64, "_f64")):
        A = torch.randn((BA_BATCH, 2 * nb_dims, nb_dims), generator=g,
                        dtype=dtype, device=dev) / (2 * nb_dims) ** 0.5
        H = A.mT @ A + 1e-3 * torch.eye(nb_dims, dtype=dtype, device=dev)
        b = torch.randn((BA_BATCH, nb_dims), generator=g, dtype=dtype,
                        device=dev)
        xt = solve_psd_cg(H, b, nb_dims)
        err = (cuda_cg.cg_solve(H, b, nb_dims) - xt).abs().max().item()
        scale = xt.abs().max().item()
        k1[f"ms{tag}"] = gpu_ms(lambda: cuda_cg.cg_solve(H, b, nb_dims), n=20)
        k1[f"plain_ms{tag}"] = gpu_ms(lambda: solve_psd_cg(H, b, nb_dims),
                                      n=3)
        k1[f"bound_ms{tag}"], k1[f"bound_by{tag}"] = k1_bound(
            BA_BATCH, nb_dims, nb_dims, H.element_size())
        k1[f"bytes_bound_ms{tag}"] = ((BA_BATCH * nb_dims * nb_dims
                                       + 2 * BA_BATCH * nb_dims)
                                      * H.element_size() / HBM_BYTES_PER_S
                                      * 1e3)
        k1[f"share{tag}"] = k1[f"bound_ms{tag}"] / k1[f"ms{tag}"]
        k1[f"max_abs_err{tag}"] = err
        k1[f"max_abs_x{tag}"] = scale
        plan = cuda_cg.k1_launch_plan(BA_BATCH, nb_dims, H.element_size(),
                                      H.data_ptr())
        log(f"[ba] K1 at ({BA_BATCH}, {nb_dims}, {nb_dims}) {dtype}, "
            f"{nb_dims} iterations ({plan.path}/{plan.h_in}): kernel "
            f"{k1[f'ms{tag}']:.4f} ms, twin {k1[f'plain_ms{tag}']:.4f} ms, "
            f"bound {k1[f'bound_ms{tag}']:.4f} ms ({k1[f'bound_by{tag}']};"
            f" bytes alone {k1[f'bytes_bound_ms{tag}']:.4f} ms), share "
            f"{k1[f'share{tag}']:.3f}, max|x_k - x_twin| {err:.3e} (max|x| "
            f"{scale:.3e}); {k1['launches']} launches on the cg path")
        # phase 3's hold of K1: 1e-5 of max|x| in float32, 1e-11 in float64
        tol = 1e-5 if dtype == torch.float32 else 1e-11
        assert err <= tol * max(1.0, scale), f"K1 at {nb_dims} {dtype}"


def marginal_iteration_ms(solve, lo, hi, reps):
    """ms an iteration by the marginal protocol of
    ``benchmarks/exp_pose_graph_iter.py``: ``solve(iters, rep) -> Output``
    (a fresh start for each ``rep``; -1 is the untimed warm-up) at
    ``max_iters`` ``lo`` and ``hi``, ``reps`` host-timed solves each;
    (min wall at hi - min wall at lo) over the iterations between.
    Returns ``(ms, walls, iterations, failures)``, the last two of each
    rep."""
    walls, runs, fails = {}, {}, {}
    for it in (lo, hi):
        solve(it, -1)
        torch.cuda.synchronize()
        ws, its, fs = [], [], []
        for r in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve(it, r)
            out.final_cost.cost.item()
            ws.append(time.perf_counter() - t0)
            its.append(int(out.num_iters))
            fs.append(int(out.num_failures))
        walls[it], runs[it], fails[it] = ws, its, fs
    d_it = runs[hi][-1] - runs[lo][-1]
    assert d_it > 0, f"the marginal protocol ran {runs} iterations"
    return ((min(walls[hi]) - min(walls[lo])) * 1e3 / d_it, walls, runs,
            fails)


def traced_iterations(solve):
    """Kernel launches and device time an iteration under torch.profiler:
    ``solve(iters) -> Output`` traced once at 2 and once at 5 iterations
    (profile_main.py's count: every kernel, memcpy and memset on the
    device; the union of their intervals).  Device activity alone is
    traced: the host's op events of a 5-iteration solve cost the profiler
    tens of seconds.  Returns ``(traced, kernels an iteration, copies an
    iteration, device ms an iteration, busy share of the traced
    5-iteration call)``."""
    from torch.profiler import ProfilerActivity, profile
    from profile_main import union_us
    traced = {}
    for it in (2, 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            o_r = solve(it)
            torch.cuda.synchronize()
        wall_on = time.perf_counter() - t0
        inside = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        assert inside, "the trace holds no device events"
        kernels = [e for e in inside
                   if not e.name.startswith(("Memcpy", "Memset"))]
        traced[it] = {
            "iters": int(o_r.num_iters), "kernels": len(kernels),
            "copies": len(inside) - len(kernels),
            "device_ms": union_us([(e.time_range.start, e.time_range.end)
                                   for e in inside]) / 1e3,
            "wall_ms_profiled": wall_on * 1e3}
    a, b = traced[2], traced[5]
    d_it = max(b["iters"] - a["iters"], 1)
    return (traced, (b["kernels"] - a["kernels"]) / d_it,
            (b["copies"] - a["copies"]) / d_it,
            (b["device_ms"] - a["device_ms"]) / d_it,
            b["device_ms"] / b["wall_ms_profiled"])


# ---- phase 17: the chain solver and the 5,000-pose pose graph (ROADMAP
# Queue 1, item 15) ----

# bench_pose_graph's row (benchmarks/run_benchmarks.py:394-420)
PG_POSES, PG_LOOPS, PG_NOISE, PG_SEED = 5000, 100, 1e-3, 4
PG_REPS = 2                  # fresh starts a max_iters value, the minimum kept


def pg_anchor(x_n, dd):
    """The pose-0 prior of ``models/pose_graph.pose_graph_optimize``."""
    from tinyopt_tpu_torch.manifolds import SE3, SO3
    q, t = dd
    return (SE3(SO3(q), t).inverse() @ x_n).log()


def pg_iter_options(to, iters):
    """``benchmarks/exp_pose_graph_iter.py``'s options: exactly ``iters``
    iterations unless a failure budget stops the solve."""
    return to.Options(max_iters=iters, min_error=0.0, min_step_norm2=0.0,
                      min_grad_norm2=0.0, min_rerr_dec=0.0,
                      hessian=to.HessianOptions(save_last=False))


def phase17(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """The chain solver (``chain.py`` over ``ops/tridiag.py``; no TPU kernel
    on the path, so neither K1 nor K2 may launch).  17a: bench_pose_graph's
    5,000 poses + 100 loop closures, float32, cyclic reduction ("auto" on
    the card), a success stop at cost <= 3 x DOF x sigma^2 (the bench's
    gate).  17b: a 200-pose /
    10-loop graph in float64, the card (cyclic reduction) against the CPU
    port (the scan), solve and marginals.  17c: ms an LM iteration by
    exp_pose_graph_iter.py's marginal protocol (max_iters 15 against 5,
    fresh starts); one solve of the 5,000-pose system with its 1 + m
    right-hand sides by each method; the marginals at 5,000 poses; kernel
    launches an iteration and the device-busy share under torch.profiler
    (counted as profile_main.py counts them).  Every line names the card
    and its power limit."""
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.chain import chain_system
    from tinyopt_tpu_torch.manifolds import SE3
    from tinyopt_tpu_torch.models.pose_graph import (
        make_pose_graph, pose_graph_edge_fn, pose_graph_marginals,
        pose_graph_optimize)
    from tinyopt_tpu_torch.ops import tridiag
    # the chain's conditioning grows like N^2: float32 products must be
    # exact (the JAX package pins them to HIGHEST for the same reason)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    smi = record["nvidia_smi"]
    rec = record["chain"] = {"card": smi}

    def reset():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        for k in tridiag.SOLVES:
            tridiag.SOLVES[k] = 0

    def shifted(x, s):
        """Poses with every translation moved by ``s`` (a fresh start)."""
        return SE3(x.rotation, x.translation + s)

    # ---- 17a: the reference's row, float32, by cyclic reduction ----
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data, x0, _ = make_pose_graph(PG_POSES, PG_LOOPS, noise=PG_NOISE,
                                  init_noise=0.05, dtype=torch.float32,
                                  seed=PG_SEED, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    E = int(data.edges.shape[0])
    m = 6 * (E - (PG_POSES - 1))
    dof = 6 * E + 6 - 6 * PG_POSES
    crit = 3.0 * max(dof, 1) * PG_NOISE ** 2
    opts = to.Options(hessian=to.HessianOptions(save_last=False)
                      ).for_dtype(torch.float32)
    pose_graph_optimize(shifted(x0, 1e-5), data, opts)   # warm-up, untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    x, out = pose_graph_optimize(x0, data, opts)
    cost = out.final_cost.cost.item()
    wall = time.perf_counter() - t0
    n = path_launches["pose_graph_cr"] = {
        "K1": cuda_cg.cg_solve.launches,
        "K2": cuda_solver.fused_solve.launches}
    solves = dict(tridiag.SOLVES)
    iters = int(out.num_iters)
    rec["solve"] = {
        "poses": PG_POSES, "edges": E, "m": m, "dims": 6 * PG_POSES,
        "generate_s": gen_s, "wall_s": wall, "iters": iters,
        "ms_per_iter_wall": wall * 1e3 / max(iters, 1), "cost": cost,
        "criterion": crit, "stop": int(out.stop_reason),
        "converged": bool(out.converged()), "solves": solves,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": n}
    log(f"[chain] {PG_POSES} poses + {E - PG_POSES + 1} loops ({6 * PG_POSES}"
        f" dims, m = {m}) float32, LM by {solves}: cost {cost:.4e} "
        f"(criterion 3 x DOF x sigma^2 = {crit:.4e}), {iters} iterations, "
        f"stop {int(out.stop_reason)}, {wall:.3f} s ({wall * 1e3 / iters:.1f}"
        f" ms an iteration, wall), peak {rec['solve']['peak_gb']:.2f} GB, "
        f"graph built in {gen_s:.2f} s; launches {n} | {smi}")
    # bench_pose_graph's gate: a success stop at the chi^2 floor (in
    # float32 the step / relative-decrease floors rarely fire there, so the
    # solve may end MAX_CONSEC_NO_DECR, a success, as the JAX package's
    # float32 solve of the 500-pose graph does on the CPU)
    assert bool(out.succeeded()), f"pose graph: stop {int(out.stop_reason)}"
    assert cost <= crit, f"pose graph: cost {cost} above {crit}"
    assert solves["cr"] > 0 and solves["scan"] == 0, solves
    assert n == {"K1": 0, "K2": 0}, f"pose graph: launches {n}"
    assert all(bool(torch.isfinite(a).all()) for a in pytree.tree_leaves(x))

    # ---- 17b: the card (cyclic reduction) against the CPU port (the
    # scan), float64, solve and marginals ----
    rec["a_s"] = time.perf_counter() - t_phase
    t_b = time.perf_counter()
    d_cpu, x_cpu, _ = make_pose_graph(200, 10, noise=PG_NOISE,
                                      init_noise=0.05, seed=PG_SEED,
                                      device="cpu")
    opts64 = to.Options(hessian=to.HessianOptions(save_last=False))
    got = []
    for where in (dev, "cpu"):
        reset()
        dd = pytree.tree_map(lambda a: a.to(where), d_cpu)
        xx, oo = pose_graph_optimize(
            pytree.tree_map(lambda a: a.to(where), x_cpu), dd, opts64)
        got.append((xx, oo, dict(tridiag.SOLVES),
                    pose_graph_marginals(xx, dd).cpu()))
    (xg, og, sg, mg), (xc, oc, sc, mc) = got
    x_gap = max((a.cpu() - b).abs().max().item()
                for a, b in zip(pytree.tree_leaves(xg),
                                pytree.tree_leaves(xc)))
    marg_gap = ((mg - mc).abs().max() / mc.abs().max()).item()
    rec["f64_vs_cpu"] = {
        "stop": [int(og.stop_reason), int(oc.stop_reason)],
        "iters": [int(og.num_iters), int(oc.num_iters)],
        "solves": [sg, sc], "x_max_abs_gap": x_gap,
        "marginals_rel_gap": marg_gap}
    log(f"[chain] 200 poses + 10 loops float64: card {sg} / CPU {sc}, stop "
        f"{rec['f64_vs_cpu']['stop']}, iterations "
        f"{rec['f64_vs_cpu']['iters']}, max |x_card - x_cpu| {x_gap:.3e}, "
        f"marginals relative gap {marg_gap:.3e} | {smi}")
    assert sg["cr"] > 0 and sg["scan"] == 0, sg
    assert sc["scan"] > 0 and sc["cr"] == 0, sc
    assert int(og.stop_reason) == int(oc.stop_reason), "200-pose stop"
    assert abs(int(og.num_iters) - int(oc.num_iters)) <= 1, "200-pose iters"
    assert x_gap <= 1e-9, f"200-pose x gap {x_gap}"
    assert marg_gap <= 1e-9, f"200-pose marginals gap {marg_gap}"

    rec["b_s"] = time.perf_counter() - t_b

    # ---- 17c: times ----
    # ms an LM iteration: max_iters 15 against 5, fresh starts each rep
    t_iter = time.perf_counter()
    per_iter, walls, runs, fails = marginal_iteration_ms(
        lambda it, r: pose_graph_optimize(shifted(x0, 1e-6 * (r + 2)), data,
                                          pg_iter_options(to, it))[1],
        5, 15, PG_REPS)
    rec["iteration"] = {"walls_s": walls, "iters": runs, "failures": fails,
                        "ms_per_iter": per_iter,
                        "protocol_s": time.perf_counter() - t_iter}
    log(f"[chain] {PG_POSES} poses float32 ms an LM iteration (marginal, "
        f"max_iters 15 against 5, min of {PG_REPS} fresh starts): "
        f"{per_iter:.2f} ms ({runs} iterations, walls {walls} s) | {smi}")

    # one solve of the system at x0 with its 1 + m right-hand sides, each
    # method: tridiagonal solve and Woodbury capacitance, damped as LM's
    # first proposal damps it (the undamped float32 system at x0 is too
    # ill-conditioned for a float32 solve to mean anything: its relative
    # residual was 0.35 by either method)
    t_solve = time.perf_counter()
    spec = mf.tangent_spec(x0)
    acc, _, _, _ = chain_system(
        x0, pose_graph_edge_fn, data.edges, (data.meas_q[None],
                                             data.meas_t[None]),
        pg_anchor, [0], (data.anchor_q[None, None],
                         data.anchor_t[None, None]), spec)
    H, g, _ = acc(mf.flatten_batch(pytree.tree_map(lambda a: a[None], x0),
                                   spec))
    rhs = -g.reshape(1, PG_POSES, 6)
    lam = opts.lm.damping_init
    Dd = H.D + torch.diag_embed(lam * torch.where(
        H.diag == 0, torch.ones_like(H.diag), H.diag))
    Hd = dataclasses.replace(H, D=Dd, diag=(1 + lam) * H.diag)
    sol = {}
    for how, reps in (("cr", 3), ("scan", 1)):
        def solve():
            return tridiag.tridiag_woodbury_solve(Dd, H.B, H.U, rhs,
                                                  method=how)
        if how == "cr":
            solve()                                      # warm-up
        ms = []
        for _ in range(reps):
            (dx, ok), t = timed(solve)
            ms.append(t)
        resid = (Hd.matvec(dx.reshape(1, -1)) - rhs.reshape(1, -1)).norm() \
            / rhs.norm()
        sol[how] = dx
        rec[f"solve_{how}"] = {"ms": ms, "ok": bool(ok.all()),
                               "rel_residual": resid.item(),
                               "rhs": 1 + H.U.shape[-1]}
        log(f"[chain] one {how} solve of the {PG_POSES}-pose system, "
            f"{1 + H.U.shape[-1]} right-hand sides, float32, LM-damped "
            f"(lambda {lam}): ms {ms}, |H_lam dx + g| / |g| = "
            f"{resid.item():.3e} | {smi}")
        assert bool(ok.all()) and bool(torch.isfinite(dx).all()), how
    gap = ((sol["cr"] - sol["scan"]).norm() / sol["scan"].norm()).item()
    rec["solve_cr_vs_scan_rel_gap"] = gap
    rec["solve_s"] = time.perf_counter() - t_solve
    log(f"[chain] |dx_cr - dx_scan| / |dx_scan| = {gap:.3e} | {smi}")

    # the marginals at 5,000 poses (the scan factor, the selected inverse's
    # reverse loop, the Woodbury downdate)
    t_marg = time.perf_counter()
    marg, t = timed(lambda: pose_graph_marginals(x, data))
    ms = [t]
    diag = torch.diagonal(marg, dim1=-2, dim2=-1)
    rec["marginals"] = {"ms": ms, "shape": list(marg.shape),
                        "finite": bool(torch.isfinite(marg).all()),
                        "min_diag": diag.min().item(),
                        "max_diag": diag.max().item()}
    log(f"[chain] pose_graph_marginals at {PG_POSES} poses float32: ms {ms},"
        f" diagonal {diag.min().item():.3e} .. {diag.max().item():.3e} | "
        f"{smi}")
    assert rec["marginals"]["finite"] and diag.min().item() > 0, "marginals"
    rec["marginals_s"] = time.perf_counter() - t_marg

    # kernel launches an iteration and the busy share: one traced solve of
    # 2 and one of 5 iterations from fresh starts
    t_prof = time.perf_counter()
    traced, per_it, copies_it, dev_it, busy_on = traced_iterations(
        lambda it: pose_graph_optimize(shifted(x0, 3e-6 * it), data,
                                       pg_iter_options(to, it))[1])
    # busy share of an iteration: its device time over the marginal
    # protocol's profiler-off ms an iteration
    busy_off = dev_it / per_iter
    rec["profile"] = {"traced": traced, "kernels_per_iter": per_it,
                      "copies_per_iter": copies_it,
                      "device_ms_per_iter": dev_it,
                      "busy_off": busy_off, "busy_on": busy_on,
                      "profile_s": time.perf_counter() - t_prof}
    log(f"[chain] {PG_POSES} poses float32 under torch.profiler: "
        f"{per_it:.1f} kernel launches an LM iteration (+ "
        f"{copies_it:.1f} copies), device "
        f"{dev_it:.2f} ms an iteration; busy share {busy_off:.4f} of the "
        f"profiler-off ms an iteration ({busy_on:.4f} of the traced 5-"
        f"iteration call); traced {traced} | {smi}")
    rec["phase_s"] = time.perf_counter() - t_phase


# ---- phase 18: the sparse-observation Schur system (ROADMAP Queue 1,
# item 16a) ----

# bench_ba_sparse's row (benchmarks/run_benchmarks.py:329-391)
BAS_CAMS, BAS_PTS, BAS_K, BAS_NOISE, BAS_SEED = 1000, 50_000, 8, 1e-3, 7
BAS_F64 = (100, 5000)        # 18b: the card against the CPU port, float64
BAS_REPS = 3                 # fresh starts a max_iters value, the minimum kept
BAL_EXCERPT = os.path.join(HERE, "tests", "data", "bal_excerpt.txt")


def bas_options(to, **hessian):
    """bench_ba_sparse's options: 12 iterations, no failure budget, no
    error floor, two refinement rounds of the reduced solve (``hessian``
    replaces fields)."""
    return to.Options(max_iters=12, max_consec_failures=0, min_error=0.0,
                      hessian=to.HessianOptions(**{**dict(
                          save_last=False, schur_refine=2), **hessian}))


def bas_iter_options(to, iters):
    """Exactly ``iters`` iterations (every stop test off, no failure
    budget), bench_ba_sparse's reduced solve, float32 thresholds."""
    return to.Options(max_iters=iters, min_error=0.0, min_step_norm2=0.0,
                      min_grad_norm2=0.0, min_rerr_dec=0.0,
                      max_consec_failures=0,
                      hessian=to.HessianOptions(save_last=False,
                                                schur_refine=2))


BAS_SPLIT_REPS = 3


def bas_split(to, x0, obs, ci, mk):
    """The stages of one LM iteration of 18a, each run alone at the start
    (λ = 1e-4): ``accumulate`` (the linearization of every slot, Ba, g, E,
    C), ``evaluate`` (the cost at a candidate), the whole ``propose``, and
    inside it the damped ``reduce`` (S, E C⁻¹ g_b, C⁻¹), the reduced solve
    by cyclic reduction (``solve_banded``, two refinement rounds, 3 CR
    solves) and by the dense Cholesky (``solve_dense``, the "off" route),
    and the landmark ``backsub``: the system's own stages
    (``propose.stages``).  Each: the median host wall of ``BAS_SPLIT_REPS``
    synchronized runs, and the device time (the union of its intervals)
    and kernel count of one more under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree
    from profile_main import union_us
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.ops import schur_obs
    from tinyopt_tpu_torch.ops.schur import _damp_blocks

    o = bas_options(to).for_dtype(torch.float32)
    a0, b0 = x0["poses"], x0["points"]
    spec = mf.tangent_spec((a0, b0))
    acc, ev, _, prop = schur_obs.schur_obs_system(ba_pair, a0, b0, obs[None],
                                                  ci, mk, spec)
    st = prop.stages
    xb = mf.flatten_batch(pytree.tree_map(lambda a: a[None], (a0, b0)), spec)
    H, g, _ = acc(xb)
    lam = torch.full((1,), 1e-4, dtype=torch.float32, device=xb.device)
    Bd = _damp_blocks(H.Ba, lam)
    g_a, g_b, E_p, Cd_p = st.reduce_inputs(
        H, schur_obs._damp_flat(H.C, 3, lam), g)
    S_f, rhs, Cinv = st.reduce(E_p, Cd_p, g_b)
    dx_a, _ = schur_obs.assemble_reduced(S_f, rhs, Bd, g_a, refine=2,
                                         band_group=st.band_group)

    stages = {
        "accumulate": lambda: acc(xb),
        "evaluate": lambda: ev(xb),
        "propose": lambda: prop(H, g, lam, o),
        "reduce": lambda: st.reduce(E_p, Cd_p, g_b),
        "solve_banded": lambda: schur_obs.assemble_reduced(
            S_f, rhs, Bd, g_a, refine=2, band_group=st.band_group),
        "solve_dense": lambda: schur_obs.assemble_reduced(
            S_f, rhs, Bd, g_a, refine=2),
        "backsub": lambda: st.backsub(E_p, Cinv, g_b, dx_a),
    }
    out = {}
    for name, fn in stages.items():
        fn()
        walls = []
        for _ in range(BAS_SPLIT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev_dev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        kern = [e for e in ev_dev
                if not e.name.startswith(("Memcpy", "Memset"))]
        out[name] = {
            "wall_ms": statistics.median(walls), "walls_ms": walls,
            "device_ms": union_us([(e.time_range.start, e.time_range.end)
                                   for e in ev_dev]) / 1e3,
            "kernels": len(kern), "copies": len(ev_dev) - len(kern)}
    return out


def phase18(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """The sparse-observation Schur system (``ops/schur_obs.py`` through
    ``schur_sparse_optimize``; no TPU kernel on the path, so neither K1 nor
    K2 may launch).  18a: bench_ba_sparse's 1,000 cameras x 50,000
    landmarks, K = 8 (400,000 observations, 156,000 tangent dims), float32
    with two refinement rounds, the banded reduced solve (bandwidth 7,
    groups of 7 cameras): a success stop at RMSE <= 1.2 x the noise; ms an
    LM iteration by the marginal protocol (max_iters 6 against 2), launches
    and device ms an iteration and the busy share under torch.profiler,
    the peak memory; one solve with the banded route off (the dense
    6,000^2 Cholesky) and one with schur_cg_iters=32.  18b: 100 x 5,000
    in float64, the card against the CPU port (assert_parity's
    tolerances), and schur_sparse_covariance with a 0.1 prior at the
    solution (relative 1e-9).  18c: the covariance at 18a's solution in
    float32 (the same prior), its ms and peak memory.  18d: the committed
    BAL excerpt (30 cameras, 600 points, 4,369 observations, padded to
    K = 30) from tests/test_bal.py's perturbation, float64, the card
    against the CPU port, RMSE < 0.55 px.  Every line names the card and
    its power limit."""
    import numpy as np
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.models.bal import bal_residual, bal_rmse, load_bal
    from tinyopt_tpu_torch.models.bundle_adjustment import (
        make_ba_problem_sparse, reprojection_rmse_sparse)
    from tinyopt_tpu_torch.ops import schur_obs
    from tinyopt_tpu_torch.output import map_output
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    smi = record["nvidia_smi"]
    rec = record["ba_sparse"] = {"card": smi}
    t_phase = time.perf_counter()

    def reset():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        for k in schur_obs.SOLVES:
            schur_obs.SOLVES[k] = 0

    def launches(key):
        n = path_launches[key] = {"K1": cuda_cg.cg_solve.launches,
                                  "K2": cuda_solver.fused_solve.launches}
        return n

    # ---- 18a: bench_ba_sparse's row, float32 ----
    t0 = time.perf_counter()
    (obs, ci, mk), x0, _ = make_ba_problem_sparse(
        n_cams=BAS_CAMS, n_pts=BAS_PTS, k_obs=BAS_K, noise=BAS_NOISE,
        seed=BAS_SEED, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    dims = 6 * BAS_CAMS + 3 * BAS_PTS
    bw = schur_obs.detect_camera_bandwidth(ci, mk)
    # the system's host planning (SegmentSum tables), once; the band group
    # its propose uses
    spec = mf.tangent_spec((x0["poses"], x0["points"]))
    t0 = time.perf_counter()
    *_, prop = schur_obs.schur_obs_system(ba_pair, x0["poses"], x0["points"],
                                          obs[None], ci, mk, spec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    group = prop.stages.band_group

    def solve(pts, o):
        return to.schur_sparse_optimize((x0["poses"], pts), ba_pair, obs, ci,
                                        mk, o.for_dtype(torch.float32))

    def rmse_of(x):
        return reprojection_rmse_sparse({"poses": x[0], "points": x[1]},
                                        obs, ci, mk).item()

    rmse0 = rmse_of((x0["poses"], x0["points"]))
    runs = {}
    for name, o in (("banded", bas_options(to)),
                    ("off", bas_options(to, schur_banded="off")),
                    ("cg32", dataclasses.replace(
                        bas_options(to, schur_refine=0, schur_cg_iters=32),
                        max_iters=24))):
        if name == "banded":
            solve(x0["points"] + 1e-3, o)        # warm-up, untimed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        x, out = solve(x0["points"], o)
        rmse = rmse_of(x)
        wall = time.perf_counter() - t0
        n = launches(f"ba_sparse_{name}")
        iters = int(out.num_iters)
        r = runs[name] = {
            "wall_s": wall, "iters": iters, "rmse": rmse, "rmse0": rmse0,
            "stop": int(out.stop_reason), "succeeded": bool(out.succeeded()),
            "ms_per_iter_wall": wall * 1e3 / max(iters, 1),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "solves": dict(schur_obs.SOLVES), "launches": n}
        log(f"[ba_sparse] {BAS_CAMS} cams x {BAS_PTS} pts, K = {BAS_K} "
            f"({dims} dims) float32 {name}: {wall:.3f} s, {iters} "
            f"iterations ({r['ms_per_iter_wall']:.1f} ms an iteration, wall"
            f" with the system's build), RMSE {rmse0:.3e} -> {rmse:.4e} "
            f"(criterion {BA_CRIT}), stop {r['stop']}, reduced solves "
            f"{r['solves']}, peak {r['peak_gb']:.2f} GB, launches {n} | "
            f"{smi}")
        assert r["succeeded"], f"ba_sparse {name}: stop {r['stop']}"
        assert rmse <= BA_CRIT, f"ba_sparse {name}: RMSE {rmse}"
        assert n == {"K1": 0, "K2": 0}, f"ba_sparse {name}: launches {n}"
        if name == "banded":
            sol = x
    rec.update(generate_s=gen_s, build_s=build_s, bandwidth=bw,
               band_group=group, runs=runs)
    log(f"[ba_sparse] bandwidth {bw}, band group {group} cameras "
        f"({-(-BAS_CAMS // max(group or 1, 1))} groups); problem drawn in "
        f"{gen_s:.2f} s, system planned in {build_s:.2f} s | {smi}")
    assert group == 7, f"band group {group}"
    assert runs["banded"]["solves"]["banded"] > 0 and \
        runs["banded"]["solves"]["dense"] == 0, runs["banded"]["solves"]
    assert runs["off"]["solves"]["dense"] > 0 and \
        runs["off"]["solves"]["banded"] == 0, runs["off"]["solves"]
    assert runs["cg32"]["solves"]["pcg"] > 0, runs["cg32"]["solves"]

    # ms an LM iteration (marginal, max_iters 6 against 2, fresh starts).
    # With every stop test off, the float32 solve runs on past its
    # convergence until λ is ~1e-7, where a float32 cyclic reduction can
    # be far off and its refinement rounds diverge; a candidate's cost
    # can then overflow and the retries end the solve SOLVER_FAILED
    # (tests/torch_ba_sparse_f32_study.py); the first 7 iterations stay
    # clear of it (a rejected step, one failure, is an ordinary iteration)
    t_iter = time.perf_counter()
    per_iter, walls, its, fails = marginal_iteration_ms(
        lambda it, r: solve(x0["points"] + 1e-6 * (r + 2),
                            bas_iter_options(to, it))[1], 2, 6, BAS_REPS)
    rec["iteration"] = {"walls_s": walls, "iters": its, "failures": fails,
                        "ms_per_iter": per_iter,
                        "protocol_s": time.perf_counter() - t_iter}
    log(f"[ba_sparse] {BAS_CAMS} x {BAS_PTS} float32 ms an LM iteration "
        f"(marginal, max_iters 6 against 2, min of {BAS_REPS} fresh "
        f"starts): {per_iter:.2f} ms ({its} iterations, {fails} failures, "
        f"walls {walls} s) | {smi}")
    assert max(f for fs in fails.values() for f in fs) <= 1, fails
    t_prof = time.perf_counter()
    traced, per_it, copies_it, dev_it, busy_on = traced_iterations(
        lambda it: solve(x0["points"] + 3e-6 * it,
                         bas_iter_options(to, it))[1])
    rec["profile"] = {"traced": traced, "kernels_per_iter": per_it,
                      "copies_per_iter": copies_it,
                      "device_ms_per_iter": dev_it,
                      "busy_off": dev_it / per_iter, "busy_on": busy_on,
                      "profile_s": time.perf_counter() - t_prof}
    log(f"[ba_sparse] {BAS_CAMS} x {BAS_PTS} float32 under torch.profiler: "
        f"{per_it:.1f} kernel launches an LM iteration (+ {copies_it:.1f} "
        f"copies), device {dev_it:.2f} ms an iteration; busy share "
        f"{dev_it / per_iter:.4f} of the profiler-off ms an iteration "
        f"({busy_on:.4f} of the traced 5-iteration call); traced {traced} "
        f"| {smi}")

    # where an LM iteration goes: its stages at 18a's start, each run alone
    t_split = time.perf_counter()
    rec["split"] = split = bas_split(to, x0, obs, ci, mk)
    rec["split_s"] = time.perf_counter() - t_split
    for name, v in split.items():
        log(f"[ba_sparse] split of an LM iteration at {BAS_CAMS} x "
            f"{BAS_PTS} float32, {name}: wall {v['wall_ms']:.2f} ms "
            f"(median of {BAS_SPLIT_REPS}), device {v['device_ms']:.2f} ms "
            f"in {v['kernels']} kernels + {v['copies']} copies | {smi}")

    # ---- 18c: the covariance at 18a's solution, float32 ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (cov_a, cov_b), ms = timed(lambda: to.schur_sparse_covariance(
        sol, ba_pair_prior, obs, ci, mk))
    diag = torch.diagonal(cov_a, dim1=-2, dim2=-1)
    rec["covariance"] = {
        "ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "finite": bool(torch.isfinite(cov_a).all()
                       and torch.isfinite(cov_b).all()),
        "min_cam_diag": diag.min().item(), "max_cam_diag": diag.max().item()}
    c = rec["covariance"]
    log(f"[ba_sparse] schur_sparse_covariance at the {BAS_CAMS} x {BAS_PTS} "
        f"solution (0.1 prior, float32, the dense {6 * BAS_CAMS}^2 S^-1): "
        f"{ms:.1f} ms, peak {c['peak_gb']:.2f} GB, finite {c['finite']}, "
        f"camera variances {c['min_cam_diag']:.3e} .. {c['max_cam_diag']:.3e}"
        f" | {smi}")
    assert c["finite"] and c["min_cam_diag"] > 0, "ba_sparse covariance"
    del obs, ci, mk, x0, sol, cov_a, cov_b
    torch.cuda.empty_cache()

    # ---- 18b: the card against the CPU port, float64 ----
    t_b = time.perf_counter()
    (o_c, c_c, m_c), x_c, _ = make_ba_problem_sparse(
        *BAS_F64, k_obs=BAS_K, noise=BAS_NOISE, seed=BAS_SEED, device="cpu")
    got = []
    for where in (dev, "cpu"):
        reset()
        data = [a.to(where) for a in (o_c, c_c, m_c)]
        xx = pytree.tree_map(lambda a: a.to(where), (x_c["poses"],
                                                     x_c["points"]))
        t0 = time.perf_counter()
        xs, out = to.schur_sparse_optimize(xx, ba_pair, *data,
                                           bas_options(to))
        out.final_cost.cost.item()
        got.append((xs, map_output(lambda v: v.cpu(), out),
                    dict(schur_obs.SOLVES), time.perf_counter() - t0))
    (xsg, og, sg, wg), (xsc, oc, sc, wc) = got
    # the covariance (0.1 prior) at the CPU port's solution, on each side
    covs = [to.schur_sparse_covariance(
        pytree.tree_map(lambda a: a.to(where), xsc), ba_pair_prior,
        *[a.to(where) for a in (o_c, c_c, m_c)]) for where in (dev, "cpu")]
    cov_gap = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(*covs))

    def flat(x):
        return torch.cat([a.reshape(-1).cpu() for a in pytree.tree_leaves(x)])

    x_gap = assert_parity((flat(xsc), oc), (flat(xsg), og), rtol=1e-5,
                          atol=1e-9, what="ba_sparse f64 card vs CPU")
    rec["f64_vs_cpu"] = {
        "size": BAS_F64, "stop": [int(og.stop_reason), int(oc.stop_reason)],
        "iters": [int(og.num_iters), int(oc.num_iters)],
        "cost": [og.final_cost.cost.item(), oc.final_cost.cost.item()],
        "solves": [sg, sc], "x_max_abs_gap": x_gap,
        "cov_rel_gap": cov_gap, "wall_s": [wg, wc],
        "phase_s": time.perf_counter() - t_b}
    log(f"[ba_sparse] {BAS_F64[0]} x {BAS_F64[1]} float64: card / CPU stop "
        f"{rec['f64_vs_cpu']['stop']}, iterations "
        f"{rec['f64_vs_cpu']['iters']}, reduced solves {sg} / {sc}, max "
        f"|x_card - x_cpu| {x_gap:.3e}; covariance (0.1 prior) at the CPU "
        f"solution, relative gap {cov_gap:.3e}; solve walls {wg:.2f} / "
        f"{wc:.2f} s | {smi}")
    assert int(og.stop_reason) == int(oc.stop_reason), "ba_sparse f64 stop"
    assert sg["banded"] > 0 and sc["banded"] > 0, (sg, sc)
    assert cov_gap <= 1e-9, f"ba_sparse f64 covariance gap {cov_gap}"

    # ---- 18d: the BAL excerpt, padded, float64 ----
    t_d = time.perf_counter()
    (bo, bc, bm), bx0 = load_bal(BAL_EXCERPT, device="cpu")
    rng = np.random.default_rng(0)
    bx0 = (bx0[0], bx0[1] + torch.as_tensor(
        rng.normal(0.0, 5e-3, tuple(bx0[1].shape))))
    o = to.Options(max_iters=20, max_consec_failures=0,
                   hessian=to.HessianOptions(save_last=False))
    got = []
    for where in (dev, "cpu"):
        reset()
        data = [a.to(where) for a in (bo, bc, bm)]
        xs, out = to.schur_sparse_optimize(
            pytree.tree_map(lambda a: a.to(where), bx0), bal_residual, *data,
            o)
        got.append((flat(xs), map_output(lambda v: v.cpu(), out),
                    bal_rmse(*xs, *data).item(), dict(schur_obs.SOLVES)))
        if where == dev:
            n_bal = launches("ba_sparse_bal")
    (xg, og, rg, sg), (xc, oc, rc, sc) = got
    x_gap = assert_parity((xc, oc), (xg, og), rtol=1e-5, atol=1e-9,
                          what="BAL excerpt card vs CPU")
    rec["bal_excerpt"] = {
        "rmse_px": [rg, rc], "stop": [int(og.stop_reason),
                                      int(oc.stop_reason)],
        "iters": [int(og.num_iters), int(oc.num_iters)], "solves": [sg, sc],
        "x_max_abs_gap": x_gap, "launches": n_bal,
        "phase_s": time.perf_counter() - t_d}
    log(f"[ba_sparse] BAL excerpt (30 cams, 600 pts, 4369 obs, K = 30) "
        f"float64: card / CPU RMSE {rg:.4f} / {rc:.4f} px (gate 0.55), "
        f"stop {rec['bal_excerpt']['stop']}, iterations "
        f"{rec['bal_excerpt']['iters']}, max |x_card - x_cpu| {x_gap:.3e}, "
        f"launches {n_bal} | {smi}")
    assert bool(og.succeeded()) and rg < 0.55, f"BAL excerpt RMSE {rg}"
    assert rec["bal_excerpt"]["launches"] == {"K1": 0, "K2": 0}
    rec["phase_s"] = time.perf_counter() - t_phase


# ---- phase 19: the K-bucketed sparse-observation BA (ROADMAP Queue 1,
# item 16c) and the robust-BAL row ----

# BAL's Trafalgar-257 (problem-257-65132-pre, grail.cs.washington.edu/
# projects/bal): 257 cameras, 65,132 landmarks, 225,911 observations.  The
# file is not in the repo, so the instance is synthetic: make_bal_problem's
# corridor at k_obs = 128, each landmark thinned to the
# clip(zipf(TRAF_ZIPF), 2, TRAF_CAP) cameras of its window nearest it
# (tests/test_bal.py:512-529's recipe keeps the first slots), TRAF_ZIPF
# chosen so the total lies within 2 % of the published count.  TRAF_CAP
# is 32, not 128: a landmark seen by 128 cameras of the 0.5-spaced rail
# sees some 32 units off-axis at depth 3-5, where BAL's k2 term turns the
# projection non-monotonic, and from the perturbed start the solve stalls
# at 12-14 px in float32 and float64 alike
TRAF_CAMS, TRAF_PTS, TRAF_OBS, TRAF_K = 257, 65_132, 225_911, 128
TRAF_CAP, TRAF_ZIPF, TRAF_SEED, BAL_NOISE = 32, 2.05, 257, 0.5
BKT_F64 = (40, 4000, 32)     # 19b: cameras, landmarks, k_obs, float64
BKT_REPS = 2                 # fresh starts a max_iters value, the minimum kept
# bench_bal_robust's row (benchmarks/run_benchmarks.py:443-515)
ROBUST_BAL = dict(n_cams=300, n_pts=20_000, k_obs=6, noise=0.5,
                  outlier_frac=0.10, seed=5)


def bal_options(to, **kw):
    """bench_bal_robust's options: 15 iterations, no failure budget, no
    error floor, two refinement rounds of the reduced solve."""
    return to.Options(**{**dict(
        max_iters=15, max_consec_failures=0, min_error=0.0,
        hessian=to.HessianOptions(save_last=False, schur_refine=2)), **kw})


def heavy_tail(data, cam_x, pt_x, cap, a, seed):
    """tests/test_bal.py:512-529's thinning of a corridor rig: landmark j
    keeps clip(zipf(a), 2, cap) of its slots (numpy's
    ``default_rng(seed)``), those of the cameras nearest it along the rail
    (``cam_x`` the cameras' and ``pt_x`` the landmarks' rail coordinate);
    the others get mask 0 and camera 0.  Returns (the thinned data,
    counts)."""
    import numpy as np
    obs, ci, mk = data
    counts = np.clip(np.random.default_rng(seed).zipf(a, ci.shape[0]), 2,
                     cap)
    dist = (cam_x[ci.long()] - pt_x[:, None]).abs()
    rank = torch.argsort(torch.argsort(dist, dim=1, stable=True), dim=1,
                         stable=True)
    keep = rank < torch.as_tensor(counts, device=ci.device)[:, None]
    return (obs, torch.where(keep, ci, torch.zeros_like(ci)),
            mk * keep.to(mk.dtype)), keep.sum(dim=1).cpu().numpy()


def bucket_stats(slabs, n_pts, k_max):
    """The layout of a bucket list: its caps and sizes, its padded slots
    against one (n_pts, k_max) slab's, and the reduce's pair products (the
    strict-lower slot pairs of each padded point: Σ n_g·K_g(K_g − 1)/2,
    against n_pts·k_max(k_max − 1)/2)."""
    sizes = [int(s[1].shape[0]) for s in slabs]
    caps = [int(s[1].shape[1]) for s in slabs]
    return {"buckets": len(slabs), "caps": caps, "sizes": sizes,
            "slots": sum(n * k for n, k in zip(sizes, caps)),
            "single_slots": n_pts * k_max,
            "pair_products": sum(n * k * (k - 1) // 2
                                 for n, k in zip(sizes, caps)),
            "single_pair_products": n_pts * k_max * (k_max - 1) // 2}


def phase19(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """The K-bucketed sparse-observation BA (``ops/schur_obs.bucket_obs``,
    ``schur_obs_bucket_system`` through ``schur_sparse_optimize_buckets``;
    no TPU kernel on the path, so neither K1 nor K2 may launch), and the
    robust-BAL row on the padded layout.  19a: BAL Trafalgar-257's size
    (257 cameras, 65,132 landmarks, ~225,911 observations, heavy-tailed to
    32 a landmark), float32, bucketed at bucket_obs's defaults, gated by a
    success stop at RMSE <= 1.1 x the noise; its buckets, slots and pair
    products against one padded slab's, the band route, ms an LM
    iteration by phase 18's marginal protocol, launches and the busy share
    under torch.profiler, peak memory.  19b: a float64 cut (phase 18's
    corridor rig at 40 x 4,000, k_obs 32, the same thinning): the card's
    bucketed solve against its padded solve (the same iterations, x within
    rtol 1e-6 / atol 1e-8) and against the CPU port's bucketed solve (rtol
    1e-5, iterations within 1),
    and schur_sparse_covariance_buckets (0.1 prior) against the padded
    covariance (relative 1e-9).  19c: the committed BAL excerpt bucketed
    (min_bucket 32), float64, the card against the CPU port, RMSE < 0.55
    px.  19d: bench_bal_robust's row as the reference defines it (300 x
    20,000, K = 6, 0.5 px noise, 10 % outliers, seed 5, float32): a
    five-stage Geman-McClure gnc_anneal through schur_sparse_optimize and
    one plain solve, gated by the reference's ok (clean-slot RMSE <= 1.3 x
    the noise, plain > 2 x the anneal's).  Every line names the card and
    its power limit."""
    import numpy as np
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch.losses import (geman_mcclure, gnc_anneal,
                                          gnc_schedule)
    from tinyopt_tpu_torch.models.bal import (bal_residual, bal_rmse,
                                              load_bal, make_bal_problem)
    from tinyopt_tpu_torch.models.bundle_adjustment import (
        make_ba_problem_sparse)
    from tinyopt_tpu_torch.ops import schur_obs
    from tinyopt_tpu_torch.output import map_output
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    smi = record["nvidia_smi"]
    rec = record["ba_buckets"] = {"card": smi}
    t_phase = time.perf_counter()

    def reset():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        for k in schur_obs.SOLVES:
            schur_obs.SOLVES[k] = 0

    def launches(key):
        path_launches[key] = {"K1": cuda_cg.cg_solve.launches,
                              "K2": cuda_solver.fused_solve.launches}
        n = path_launches[key]
        assert n == {"K1": 0, "K2": 0, "K2 warp": 0}, f"{key}: launches {n}"
        return n

    def flat(x):
        return torch.cat([a.reshape(-1).cpu() for a in pytree.tree_leaves(x)])

    def to_dev(tree, where):
        return pytree.tree_map(lambda a: a.to(where), tree)

    # ---- 19a: Trafalgar-257's size, float32, bucketed ----
    t0 = time.perf_counter()
    data, x0, xt, _ = make_bal_problem(
        n_cams=TRAF_CAMS, n_pts=TRAF_PTS, k_obs=TRAF_K, noise=BAL_NOISE,
        seed=TRAF_SEED, dtype=torch.float32, device=dev)
    (obs, ci, mk), counts = heavy_tail(
        data, -xt[0]["pose"].translation[:, 0], xt[1][:, 0], TRAF_CAP,
        TRAF_ZIPF, TRAF_SEED)
    del data, xt
    slabs = schur_obs.bucket_obs(obs, ci, mk)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n_obs = int(counts.sum())
    lay = bucket_stats(slabs, TRAF_PTS, TRAF_CAP)
    bw = max(schur_obs.detect_camera_bandwidth(s[1], s[2]) for s in slabs)
    group = schur_obs.pick_band_group(bw, TRAF_CAMS, 9)
    rec["layout"] = {**lay, "observations": n_obs, "zipf_a": TRAF_ZIPF,
                     "count_mean": float(counts.mean()),
                     "count_max": int(counts.max()),
                     "count_hist": np.bincount(counts).tolist(),
                     "bandwidth": bw, "band_group": group,
                     "generate_s": gen_s}
    log(f"[ba_buckets] Trafalgar-257's size: {TRAF_CAMS} cams x {TRAF_PTS} "
        f"pts, {n_obs} observations (published {TRAF_OBS}; zipf a = "
        f"{TRAF_ZIPF}, counts mean {counts.mean():.3f} max {counts.max()}, "
        f"the nearest of a {TRAF_K}-camera window), {lay['buckets']} "
        f"buckets, caps {lay['caps']}, points {lay['sizes']}: "
        f"{lay['slots']} slots against one slab's {lay['single_slots']} "
        f"({TRAF_PTS * TRAF_K} as drawn), {lay['pair_products']} pair "
        f"products against {lay['single_pair_products']}; bandwidth {bw}, "
        f"band group "
        f"{group} ({'banded' if group else 'dense'} reduced solve); drawn "
        f"and bucketed in {gen_s:.1f} s | {smi}")
    assert abs(n_obs / TRAF_OBS - 1.0) <= 0.02, n_obs

    o32 = bal_options(to).for_dtype(torch.float32)

    def solve(pts, o):
        return to.schur_sparse_optimize_buckets((x0[0], pts), bal_residual,
                                                slabs, o)

    def rmse_of(x):
        return bal_rmse(*x, obs, ci, mk).item()

    rmse0 = rmse_of(x0)
    solve(x0[1] + 1e-3, bas_iter_options(to, 2))  # warm-up, untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    x, out = solve(x0[1], o32)
    rmse = rmse_of(x)
    wall = time.perf_counter() - t0
    n = launches("ba_buckets_trafalgar")
    iters = int(out.num_iters)
    rec["solve"] = {
        "wall_s": wall, "iters": iters, "rmse_px": rmse, "rmse0_px": rmse0,
        "stop": int(out.stop_reason), "succeeded": bool(out.succeeded()),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "solves": dict(schur_obs.SOLVES), "launches": n}
    r = rec["solve"]
    log(f"[ba_buckets] Trafalgar-257's size float32, bucketed: {wall:.3f} s "
        f"(the system's build included), {iters} iterations, RMSE "
        f"{rmse0:.3f} -> {rmse:.4f} px (gate {1.1 * BAL_NOISE:.2f}), stop "
        f"{r['stop']}, reduced solves {r['solves']}, peak "
        f"{r['peak_gb']:.2f} GB, launches {n} | {smi}")
    assert r["succeeded"] and rmse <= 1.1 * BAL_NOISE, r
    assert r["solves"]["banded" if group else "dense"] > 0, r["solves"]

    # ms an LM iteration (phase 18's marginal protocol, max_iters 6
    # against 2, fresh starts), then launches and the busy share
    t_iter = time.perf_counter()
    per_iter, walls, its, fails = marginal_iteration_ms(
        lambda it, rr: solve(x0[1] + 1e-6 * (rr + 2),
                             bas_iter_options(to, it))[1], 2, 6, BKT_REPS)
    rec["iteration"] = {"walls_s": walls, "iters": its, "failures": fails,
                        "ms_per_iter": per_iter,
                        "protocol_s": time.perf_counter() - t_iter}
    log(f"[ba_buckets] Trafalgar-257's size float32 ms an LM iteration "
        f"(marginal, max_iters 6 against 2, min of {BKT_REPS} fresh "
        f"starts): {per_iter:.2f} ms ({its} iterations, {fails} failures, "
        f"walls {walls} s) | {smi}")
    t_prof = time.perf_counter()
    traced, per_it, copies_it, dev_it, busy_on = traced_iterations(
        lambda it: solve(x0[1] + 3e-6 * it, bas_iter_options(to, it))[1])
    rec["profile"] = {"traced": traced, "kernels_per_iter": per_it,
                      "copies_per_iter": copies_it,
                      "device_ms_per_iter": dev_it,
                      "busy_off": dev_it / per_iter, "busy_on": busy_on,
                      "profile_s": time.perf_counter() - t_prof}
    log(f"[ba_buckets] Trafalgar-257's size float32 under torch.profiler: "
        f"{per_it:.1f} kernel launches an LM iteration (+ {copies_it:.1f} "
        f"copies), device {dev_it:.2f} ms an iteration; busy share "
        f"{dev_it / per_iter:.4f} of the profiler-off ms an iteration "
        f"({busy_on:.4f} of the traced 5-iteration call); traced {traced} "
        f"| {smi}")
    rec["a_s"] = time.perf_counter() - t_phase
    del obs, ci, mk, x0, slabs, x
    torch.cuda.empty_cache()

    # ---- 19b: a float64 cut, the card's bucketed solve against its padded
    # solve and the CPU port's, and the covariances: phase 18's corridor
    # rig (so 18b's 0.1 prior, ba_pair_prior, applies as it is) thinned as
    # 19a ----
    t_b = time.perf_counter()
    nc, npt, kk = BKT_F64
    data, xc, xt = make_ba_problem_sparse(n_cams=nc, n_pts=npt, k_obs=kk,
                                          noise=BAS_NOISE, seed=BAS_SEED,
                                          device="cpu")
    xc = (xc["poses"], xc["points"])
    data, counts = heavy_tail(data, -xt["poses"].translation[:, 0],
                              xt["points"][:, 0], kk, TRAF_ZIPF, TRAF_SEED)
    slabs_c = schur_obs.bucket_obs(*data, min_bucket=64)
    o64 = bas_options(to)
    got = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        reset()
        sl = [(o.to(where), c.to(where), m.to(where), i)
              for o, c, m, i in slabs_c]
        t0 = time.perf_counter()
        xs, out = to.schur_sparse_optimize_buckets(to_dev(xc, where),
                                                   ba_pair, sl, o64)
        out.final_cost.cost.item()
        got[name] = (xs, map_output(lambda v: v.cpu(), out),
                     dict(schur_obs.SOLVES), time.perf_counter() - t0)
        if name == "card":
            n_b = launches("ba_buckets_f64")
    reset()
    xp, op = to.schur_sparse_optimize(to_dev(xc, dev), ba_pair,
                                      *to_dev(data, dev), o64)
    n_p = launches("ba_buckets_f64_padded")
    (xg, og, sg, wg), (xcc, oc, sc, wc) = got["card"], got["cpu"]
    x_gap = assert_parity((flat(xcc), oc), (flat(xg), og), rtol=1e-5,
                          atol=1e-9, what="ba_buckets f64 card vs CPU")
    torch.testing.assert_close(flat(xg), flat(xp), rtol=1e-6, atol=1e-8,
                               msg="ba_buckets f64 bucketed vs padded")
    assert int(og.num_iters) == int(op.num_iters), "bucketed vs padded"
    pad_gap = (flat(xg) - flat(xp)).abs().max().item()
    covs = [to.schur_sparse_covariance_buckets(
                to_dev(xg, dev), ba_pair_prior,
                [(o.to(dev), c.to(dev), m.to(dev), i)
                 for o, c, m, i in slabs_c]),
            to.schur_sparse_covariance(to_dev(xg, dev), ba_pair_prior,
                                       *to_dev(data, dev))]
    cov_gap = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(*covs))
    rec["f64"] = {
        "size": BKT_F64, "observations": int(counts.sum()),
        "layout": bucket_stats(slabs_c, npt, kk),
        "stop": [int(og.stop_reason), int(oc.stop_reason),
                 int(op.stop_reason)],
        "iters": [int(og.num_iters), int(oc.num_iters), int(op.num_iters)],
        "solves": [sg, sc], "x_gap_card_cpu": x_gap,
        "x_gap_bucketed_padded": pad_gap, "cov_rel_gap": cov_gap,
        "wall_s": [wg, wc], "launches": [n_b, n_p],
        "phase_s": time.perf_counter() - t_b}
    f = rec["f64"]
    log(f"[ba_buckets] corridor {nc} x {npt} (k_obs {kk} thinned, "
        f"{f['observations']} observations, {len(slabs_c)} buckets) "
        f"float64: card bucketed / CPU bucketed / card padded stop "
        f"{f['stop']}, iterations {f['iters']}; max |x_card - x_cpu| "
        f"{x_gap:.3e}, max |x_bucketed - x_padded| {pad_gap:.3e}; "
        f"covariance (0.1 prior) bucketed against padded, relative gap "
        f"{cov_gap:.3e}; solve walls {wg:.2f} / {wc:.2f} s | {smi}")
    assert bool(og.succeeded()) and len(slabs_c) >= 2, f
    assert cov_gap <= 1e-9, f"ba_buckets f64 covariance gap {cov_gap}"

    # ---- 19c: the BAL excerpt, bucketed, float64 ----
    t_c = time.perf_counter()
    bslabs, bx0 = load_bal(BAL_EXCERPT, layout="bucketed", min_bucket=32,
                           device="cpu")
    (bo, bc, bm), _ = load_bal(BAL_EXCERPT, device="cpu")
    rng = np.random.default_rng(0)
    bx0 = (bx0[0], bx0[1] + torch.as_tensor(
        rng.normal(0.0, 5e-3, tuple(bx0[1].shape))))
    o = to.Options(max_iters=20, max_consec_failures=0,
                   hessian=to.HessianOptions(save_last=False))
    got = []
    for where in (dev, "cpu"):
        reset()
        sl = [(a.to(where), c.to(where), m.to(where), i)
              for a, c, m, i in bslabs]
        xs, out = to.schur_sparse_optimize_buckets(to_dev(bx0, where),
                                                   bal_residual, sl, o)
        got.append((flat(xs), map_output(lambda v: v.cpu(), out),
                    bal_rmse(*to_dev(xs, "cpu"), bo, bc, bm).item()))
        if where == dev:
            n_c = launches("ba_buckets_bal")
    (xg, og, rg), (xcc, oc, rc) = got
    x_gap = assert_parity((xcc, oc), (xg, og), rtol=1e-5, atol=1e-9,
                          what="BAL excerpt bucketed card vs CPU")
    rec["bal_excerpt"] = {
        "buckets": bucket_stats(bslabs, 600, 30), "rmse_px": [rg, rc],
        "stop": [int(og.stop_reason), int(oc.stop_reason)],
        "iters": [int(og.num_iters), int(oc.num_iters)],
        "x_max_abs_gap": x_gap, "launches": n_c,
        "phase_s": time.perf_counter() - t_c}
    c = rec["bal_excerpt"]
    log(f"[ba_buckets] BAL excerpt bucketed (min_bucket 32: caps "
        f"{c['buckets']['caps']}, {c['buckets']['slots']} slots against "
        f"{c['buckets']['single_slots']}) float64: card / CPU RMSE "
        f"{rg:.4f} / {rc:.4f} px (gate 0.55), stop {c['stop']}, iterations "
        f"{c['iters']}, max |x_card - x_cpu| {x_gap:.3e}, launches {n_c} | "
        f"{smi}")
    assert bool(og.succeeded()) and rg < 0.55, f"BAL excerpt RMSE {rg}"

    # ---- 19d: the robust-BAL row, padded, float32 ----
    t_d = time.perf_counter()
    (obs, ci, mk), x0, _, bad = make_bal_problem(
        **ROBUST_BAL, dtype=torch.float32, device=dev)
    (obs_c, _, _), _, _, _ = make_bal_problem(
        **{**ROBUST_BAL, "outlier_frac": 0.0}, dtype=torch.float32,
        device=dev)
    # the bench's clean-slot metric on determined landmarks (fewer than 2
    # clean rays cannot be recovered under a saturating loss)
    det = (bad.shape[1] - bad.sum(1)) >= 2
    good = ((~bad) & det[:, None]).to(torch.float32)

    def clean_rmse(x):
        return bal_rmse(*x, obs_c, ci, mk * good).item()

    o_r = bal_options(to).for_dtype(torch.float32)
    stages = []

    def stage(x, th2, rp):
        x, out = to.schur_sparse_optimize(x, rp, obs, ci, mk, o_r)
        stages.append({"th2": th2, "iters": int(out.num_iters),
                       "stop": int(out.stop_reason)})
        return x, out

    sched = gnc_schedule(50.0, 2.0, steps=5)
    reset()
    t0 = time.perf_counter()
    x_gnc, out = gnc_anneal(stage, x0, sched, residual_fn=bal_residual,
                            robust_fn=geman_mcclure)
    r_gnc = clean_rmse(x_gnc)
    wall = time.perf_counter() - t0
    n_g = launches("ba_robust_gnc")
    reset()
    t0 = time.perf_counter()
    x_plain, out_p = to.schur_sparse_optimize(x0, bal_residual, obs, ci, mk,
                                              o_r)
    r_plain = clean_rmse(x_plain)
    wall_p = time.perf_counter() - t0
    n_l = launches("ba_robust_plain")
    ok = r_gnc <= 1.3 * ROBUST_BAL["noise"] and r_plain > 2.0 * r_gnc
    rec["robust"] = {"rmse_px_gnc": r_gnc, "rmse_px_plain": r_plain,
                     "ok": ok, "anneal_wall_s": wall, "plain_wall_s": wall_p,
                     "stages": stages,
                     "plain_iters": int(out_p.num_iters),
                     "plain_stop": int(out_p.stop_reason),
                     "plain_failures": int(out_p.num_failures),
                     "launches": [n_g, n_l],
                     "phase_s": time.perf_counter() - t_d}
    log(f"[ba_buckets] robust BAL (bench_bal_robust: {ROBUST_BAL}) float32: "
        f"Geman-McClure anneal over {len(sched)} stages (iterations "
        f"{[s['iters'] for s in stages]}) {wall:.2f} s, clean-slot RMSE "
        f"{r_gnc:.4f} px against plain least squares {r_plain:.4f} px "
        f"({int(out_p.num_iters)} iterations, {int(out_p.num_failures)} "
        f"failures, stop {int(out_p.stop_reason)}, {wall_p:.2f} s); ok {ok} "
        f"(RMSE <= {1.3 * ROBUST_BAL['noise']:.2f} and plain > 2 x anneal) "
        f"| {smi}")
    assert ok, rec["robust"]
    rec["phase_s"] = time.perf_counter() - t_phase


# ---- phase 20: multi-device solving on the card (ROADMAP Queue 1, item 17)
# on a one-rank NCCL mesh (the smoke run needs one card, and NCCL
# takes one rank a card), then two gloo ranks on the one card ----

MESH_TURNS = 10              # 20a: rounds of (mesh, plain, plain, mesh)
MESH_BLOCKS, MESH_BLOCK_D = 8192, 16
MESH_REPS = 3                # 20c / 20d: fresh starts a max_iters value
DRYRUN_RANKS, DRYRUN_TIMEOUT = 2, 300
DRYRUN_AXES = ("dp", "block", "schur", "schur_obs", "bucketed", "chain")


def same(a, b) -> bool:
    """Bit for bit, NaN where NaN (``torch.equal`` but for NaNs)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def output_tensors(out):
    """Every tensor of an ``Output``, by field name."""
    got = {f"final_cost.{f.name}": getattr(out.final_cost, f.name)
           for f in dataclasses.fields(out.final_cost)}
    got.update((f.name, getattr(out, f.name))
               for f in dataclasses.fields(out))
    return {k: v for k, v in got.items() if isinstance(v, torch.Tensor)}


def phase20(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """Multi-device solving (``tinyopt_tpu_torch.parallel``) on the card.
    20a-20d run on a one-rank NCCL mesh, set up in this process on a file
    store and destroyed at the phase's end: the sharded code paths with
    their real collectives and device placement.  20a: batched_optimize
    with a mesh on the bench problem (prior-50, 10,000 instances, float32,
    fused, bench.py's options): x and every Output tensor bit for bit
    against the unsharded call, K2 launched once and K1 never, the call's
    wall in turns with the unsharded call (the mesh's host cost).  20b:
    sharded_optimize on 8,192 prior blocks of 16 residuals (d = 16) with
    solver="cg" (K1), held to the dense optimize of the stacked residual
    with the JAX dryrun's block tolerances.  20c: sharded_schur_sparse_
    optimize on phase 18a's instance and options (1,000 x 50,000 float32)
    held to the unsharded solve (success class, iterations within 1, RMSE
    <= 1.2e-3 and within 1 %), ms an LM iteration in turns with it,
    launches and the busy share; phase 19b's float64 corridor sharded
    against unsharded, x and the covariance to 1e-10.  20d: the K-bucketed
    BA at phase 19a's Trafalgar-257 size, held to the unsharded bucketed
    solve (success, iterations within 1, RMSE within 1 %), ms an iteration
    and launches.  20e: the dryrun's six axes on two gloo ranks sharing
    the card, as a subprocess.  Every line names the card and its power
    limit."""
    import shutil
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch.models.bal import bal_residual, bal_rmse
    from tinyopt_tpu_torch.models.bal import make_bal_problem
    from tinyopt_tpu_torch.models.bundle_adjustment import (
        make_ba_problem_sparse, reprojection_rmse_sparse)
    from tinyopt_tpu_torch.models.problems import (make_prior_batch,
                                                   prior_residual)
    from tinyopt_tpu_torch.ops import schur_obs
    from tinyopt_tpu_torch.parallel import (
        init_distributed, local_mesh, sharded_optimize,
        sharded_schur_sparse_covariance, sharded_schur_sparse_optimize,
        sharded_schur_sparse_optimize_buckets)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    smi = record["nvidia_smi"]
    rec = record["mesh"] = {"card": smi}
    t_phase = time.perf_counter()

    def reset():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        for k in schur_obs.SOLVES:
            schur_obs.SOLVES[k] = 0

    def launches(key):
        path_launches[key] = {"K1": cuda_cg.cg_solve.launches,
                              "K2": cuda_solver.fused_solve.launches}
        return path_launches[key]

    def part(name, t0):
        rec[f"{name}_s"] = time.perf_counter() - t0
        log(f"[time] phase20{name} {rec[f'{name}_s']:.1f} s")

    def flat(x):
        return torch.cat([a.reshape(-1).cpu() for a in pytree.tree_leaves(x)])

    store = tempfile.mkdtemp()
    init_distributed(device="cuda", init_method=f"file://{store}/store",
                     rank=0, world_size=1)
    try:
        # ---- 20a: the bench problem, instances over the mesh ----
        t0 = time.perf_counter()
        mesh = local_mesh("batch")
        rec["backend"] = dist.get_backend()
        assert rec["backend"] == "nccl", rec["backend"]
        gen = torch.Generator(device=dev).manual_seed(20)
        data, x0 = make_prior_batch(BATCH, DIMS, torch.float32,
                                    generator=gen, device=dev)
        opts = bench_options(to)

        def call(m):
            out = to.batched_optimize(x0, prior_residual, opts,
                                      data_batch=data, mesh=m)
            torch.cuda.synchronize()
            return out

        call(mesh)                           # warm-up (NCCL's first call)
        reset()
        x_m, out_m = call(mesh)
        n = launches("dp_fused")
        x_u, out_u = call(None)
        assert n == {"K1": 0, "K2": 1, "K2 warp": 0}, f"dp_fused: {n}"
        assert same(x_m, x_u), "dp: x differs from the unsharded call"
        tm, tu = output_tensors(out_m), output_tensors(out_u)
        differ = [k for k in tu if not same(tm[k], tu[k])]
        assert tm.keys() == tu.keys() and not differ, f"dp: {differ}"
        walls = {"mesh": [], "plain": []}
        for _ in range(MESH_TURNS):
            for name in ("mesh", "plain", "plain", "mesh"):
                t1 = time.perf_counter()
                call(mesh if name == "mesh" else None)
                walls[name].append((time.perf_counter() - t1) * 1e3)
        med = {k: statistics.median(v) for k, v in walls.items()}
        rec["dp"] = {"launches": n, "bit_equal": True,
                     "outputs": sorted(tm), "walls_ms": walls,
                     "median_ms": med,
                     "mesh_cost_ms": med["mesh"] - med["plain"],
                     "conv": out_m.converged().float().mean().item()}
        log(f"[mesh] 20a dp: batched_optimize(mesh=local_mesh('batch')) "
            f"on prior-50 x {BATCH} float32 fused, one-rank NCCL: x and "
            f"{len(tm)} Output tensors bit for bit against the unsharded "
            f"call, launches {n}, conv {rec['dp']['conv']:.4f}; wall in "
            f"turns (mesh, plain, plain, mesh) x {MESH_TURNS}: median "
            f"{med['mesh']:.3f} ms with the mesh, {med['plain']:.3f} ms "
            f"without ({med['mesh'] - med['plain']:+.3f} ms, the mesh's "
            f"host cost); walls {walls} | {smi}")
        del data, x0, x_m, x_u, out_m, out_u
        part("a", t0)

        # ---- 20b: one problem's residual blocks over the mesh, "cg" ----
        t0 = time.perf_counter()
        bmesh = local_mesh("block")
        pdata, px0 = make_prior_batch(MESH_BLOCKS, MESH_BLOCK_D,
                                      torch.float32, generator=gen,
                                      device=dev)
        bopts = to.Options(max_iters=10,
                           hessian=to.HessianOptions(solver="cg"))
        reset()
        xb, ob = sharded_optimize(px0[0], prior_residual, pdata, bopts,
                                  mesh=bmesh, axis="block")
        ob.final_cost.cost.item()
        n = launches("block_cg")
        xd, od = to.optimize(px0[0],
                             lambda x: prior_residual(x, pdata).reshape(-1),
                             bopts)
        gap = (xb - xd).abs().max().item()
        rec["block"] = {
            "blocks": MESH_BLOCKS, "d": MESH_BLOCK_D, "launches": n,
            "iters": [int(ob.num_iters), int(od.num_iters)],
            "stop": [int(ob.stop_reason), int(od.stop_reason)],
            "cost": [ob.final_cost.cost.item(), od.final_cost.cost.item()],
            "x_max_abs_gap": gap}
        log(f"[mesh] 20b block: sharded_optimize of {MESH_BLOCKS} prior "
            f"blocks x {MESH_BLOCK_D} residuals (d = {MESH_BLOCK_D}) float32"
            f" \"cg\": iterations {rec['block']['iters']} (sharded / dense"
            f"), stop {rec['block']['stop']}, cost {rec['block']['cost']}, "
            f"max |x - x_dense| {gap:.3e} (gate 5e-4), launches {n} | {smi}")
        assert bool(ob.succeeded()) and bool(ob.converged()), rec["block"]
        assert n["K1"] > 0 and n["K2"] == 0, f"block_cg: {n}"
        assert gap <= 5e-4, rec["block"]
        torch.testing.assert_close(ob.final_cost.cost, od.final_cost.cost,
                                   rtol=1e-3, atol=1e-6)
        del pdata, px0
        part("b", t0)

        # ---- 20c: phase 18a's instance over the mesh ----
        t0 = time.perf_counter()
        (obs, ci, mk), x0, _ = make_ba_problem_sparse(
            n_cams=BAS_CAMS, n_pts=BAS_PTS, k_obs=BAS_K, noise=BAS_NOISE,
            seed=BAS_SEED, dtype=torch.float32, device=dev)
        o32 = bas_options(to).for_dtype(torch.float32)

        def solve(pts, o, m):
            if m is None:
                return to.schur_sparse_optimize((x0["poses"], pts), ba_pair,
                                                obs, ci, mk, o)
            return sharded_schur_sparse_optimize(
                (x0["poses"], pts), ba_pair, obs, ci, mk, o, mesh=m)

        def rmse_of(x):
            return reprojection_rmse_sparse({"poses": x[0], "points": x[1]},
                                            obs, ci, mk).item()

        solve(x0["points"] + 1e-3, bas_iter_options(to, 2), bmesh)
        runs = {}
        for name, m in (("mesh", bmesh), ("plain", None)):
            torch.cuda.synchronize()
            reset()
            t1 = time.perf_counter()
            x, out = solve(x0["points"], o32, m)
            rmse = rmse_of(x)
            runs[name] = {
                "wall_s": time.perf_counter() - t1,
                "iters": int(out.num_iters), "rmse": rmse,
                "stop": int(out.stop_reason),
                "succeeded": bool(out.succeeded()),
                "solves": dict(schur_obs.SOLVES),
                "launches": launches(f"ba_sparse_{name}_20c")}
        r, u = runs["mesh"], runs["plain"]
        ref18 = record.get("ba_sparse", {}).get("runs", {}).get("banded")
        per_iter = {"mesh": [], "plain": []}
        for name in ("mesh", "plain", "plain", "mesh"):
            ms, walls, its, fails = marginal_iteration_ms(
                lambda it, rr, m=(bmesh if name == "mesh" else None):
                solve(x0["points"] + 1e-6 * (rr + 2),
                      bas_iter_options(to, it), m)[1], 2, 6, MESH_REPS)
            per_iter[name].append(ms)
        traced, per_it, copies_it, dev_it, busy_on = traced_iterations(
            lambda it: solve(x0["points"] + 3e-6 * it,
                             bas_iter_options(to, it), bmesh)[1])
        ms_mesh = statistics.mean(per_iter["mesh"])
        rec["ba_sparse"] = {
            "runs": runs, "ms_per_iter": per_iter,
            "rmse_18a": None if ref18 is None else ref18["rmse"],
            "kernels_per_iter": per_it, "copies_per_iter": copies_it,
            "device_ms_per_iter": dev_it, "busy_off": dev_it / ms_mesh,
            "busy_on": busy_on}
        log(f"[mesh] 20c sharded_schur_sparse_optimize {BAS_CAMS} x "
            f"{BAS_PTS} float32 (18a's options), one-rank NCCL: "
            f"{r['wall_s']:.3f} s, {r['iters']} iterations, RMSE "
            f"{r['rmse']:.4e}, stop {r['stop']}, reduced solves "
            f"{r['solves']}; unsharded {u['wall_s']:.3f} s, {u['iters']} "
            f"iterations, RMSE {u['rmse']:.4e}, stop {u['stop']}; ms an LM "
            f"iteration in turns (mesh, plain, plain, mesh): mesh "
            f"{per_iter['mesh']}, plain {per_iter['plain']}; "
            f"{per_it:.1f} launches (+ {copies_it:.1f} copies) and "
            f"{dev_it:.2f} device ms an iteration, busy share "
            f"{dev_it / ms_mesh:.4f}; launches {r['launches']} | {smi}")
        assert r["succeeded"] == u["succeeded"] and r["succeeded"], runs
        assert abs(r["iters"] - u["iters"]) <= 1, runs
        assert r["rmse"] <= BA_CRIT, runs
        assert abs(r["rmse"] / u["rmse"] - 1.0) <= 0.01, runs
        if ref18 is not None:
            assert abs(r["rmse"] / ref18["rmse"] - 1.0) <= 0.01, (r, ref18)
        assert r["launches"] == {"K1": 0, "K2": 0, "K2 warp": 0}, r
        assert r["solves"]["banded"] > 0, r["solves"]
        del obs, ci, mk, x0, x
        torch.cuda.empty_cache()

        # 19b's float64 corridor: sharded against unsharded, x and the
        # covariance (0.1 prior) at the solution
        nc, npt, kk = BKT_F64
        cdata, xc, xt = make_ba_problem_sparse(
            n_cams=nc, n_pts=npt, k_obs=kk, noise=BAS_NOISE, seed=BAS_SEED,
            device=dev)
        xc = (xc["poses"], xc["points"])
        cdata, _ = heavy_tail(cdata, -xt["poses"].translation[:, 0],
                              xt["points"][:, 0], kk, TRAF_ZIPF, TRAF_SEED)
        o64 = bas_options(to)
        xs, os_ = sharded_schur_sparse_optimize(xc, ba_pair, *cdata, o64,
                                                mesh=bmesh)
        xu, ou = to.schur_sparse_optimize(xc, ba_pair, *cdata, o64)
        x_gap = (flat(xs) - flat(xu)).abs().max().item()
        cs = sharded_schur_sparse_covariance(xu, ba_pair_prior, *cdata,
                                             mesh=bmesh)
        cu = to.schur_sparse_covariance(xu, ba_pair_prior, *cdata)
        cov_gap = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(cs, cu))
        rec["ba_sparse"]["f64"] = {
            "size": BKT_F64, "iters": [int(os_.num_iters),
                                       int(ou.num_iters)],
            "stop": [int(os_.stop_reason), int(ou.stop_reason)],
            "x_max_abs_gap": x_gap, "cov_rel_gap": cov_gap}
        log(f"[mesh] 20c corridor {nc} x {npt} float64 (19b's rig, padded):"
            f" sharded / unsharded iterations "
            f"{rec['ba_sparse']['f64']['iters']}, stop "
            f"{rec['ba_sparse']['f64']['stop']}, max |x_mesh - x| "
            f"{x_gap:.3e}, covariance (0.1 prior) relative gap "
            f"{cov_gap:.3e} (gates 1e-10) | {smi}")
        assert int(os_.stop_reason) == int(ou.stop_reason), "20c f64 stop"
        assert x_gap <= 1e-10 and cov_gap <= 1e-10, rec["ba_sparse"]["f64"]
        del cdata, xc, xt, xs, xu, cs, cu
        part("c", t0)

        # ---- 20d: phase 19a's Trafalgar-257 size, bucketed, over the mesh
        t0 = time.perf_counter()
        data, x0, xt, _ = make_bal_problem(
            n_cams=TRAF_CAMS, n_pts=TRAF_PTS, k_obs=TRAF_K, noise=BAL_NOISE,
            seed=TRAF_SEED, dtype=torch.float32, device=dev)
        (obs, ci, mk), _ = heavy_tail(
            data, -xt[0]["pose"].translation[:, 0], xt[1][:, 0], TRAF_CAP,
            TRAF_ZIPF, TRAF_SEED)
        del data, xt
        slabs = schur_obs.bucket_obs(obs, ci, mk)
        o32 = bal_options(to).for_dtype(torch.float32)

        def bsolve(pts, o, m):
            if m is None:
                return to.schur_sparse_optimize_buckets(
                    (x0[0], pts), bal_residual, slabs, o)
            return sharded_schur_sparse_optimize_buckets(
                (x0[0], pts), bal_residual, slabs, o, mesh=m)

        bsolve(x0[1] + 1e-3, bas_iter_options(to, 2), bmesh)
        runs = {}
        for name, m in (("mesh", bmesh), ("plain", None)):
            torch.cuda.synchronize()
            reset()
            t1 = time.perf_counter()
            x, out = bsolve(x0[1], o32, m)
            rmse = bal_rmse(*x, obs, ci, mk).item()
            runs[name] = {
                "wall_s": time.perf_counter() - t1,
                "iters": int(out.num_iters), "rmse_px": rmse,
                "stop": int(out.stop_reason),
                "succeeded": bool(out.succeeded()),
                "launches": launches(f"ba_buckets_{name}_20d")}
        per_iter, walls, its, fails = marginal_iteration_ms(
            lambda it, rr: bsolve(x0[1] + 1e-6 * (rr + 2),
                                  bas_iter_options(to, it), bmesh)[1],
            2, 6, MESH_REPS)
        r, u = runs["mesh"], runs["plain"]
        rec["ba_buckets"] = {"buckets": len(slabs), "runs": runs,
                             "ms_per_iter": per_iter, "walls_s": walls}
        log(f"[mesh] 20d sharded_schur_sparse_optimize_buckets at "
            f"Trafalgar-257's size ({TRAF_CAMS} x {TRAF_PTS}, {len(slabs)} "
            f"buckets) float32, one-rank NCCL: {r['wall_s']:.3f} s, "
            f"{r['iters']} iterations, RMSE {r['rmse_px']:.4f} px, stop "
            f"{r['stop']}; unsharded {u['wall_s']:.3f} s, {u['iters']} "
            f"iterations, RMSE {u['rmse_px']:.4f} px; {per_iter:.2f} ms an "
            f"LM iteration (marginal, max_iters 6 against 2, min of "
            f"{MESH_REPS}); launches {r['launches']} | {smi}")
        assert r["succeeded"] and u["succeeded"], runs
        assert abs(r["iters"] - u["iters"]) <= 1, runs
        assert abs(r["rmse_px"] / u["rmse_px"] - 1.0) <= 0.01, runs
        assert r["launches"] == {"K1": 0, "K2": 0, "K2 warp": 0}, r
        del obs, ci, mk, x0, slabs, x
        torch.cuda.empty_cache()
        part("d", t0)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # ---- 20e: the dryrun's six axes, two gloo ranks on the one card ----
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tinyopt_tpu_torch.parallel.dryrun",
         str(DRYRUN_RANKS), "--device", "cuda", "--timeout",
         str(DRYRUN_TIMEOUT)], cwd=HERE, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT + 60)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[dryrun]")]
    for ln in lines:
        log(ln)
    seen = {a: sum(ln.startswith(f"[dryrun] {a}:") for ln in lines)
            for a in DRYRUN_AXES}
    rec["dryrun"] = {"ranks": DRYRUN_RANKS, "rc": proc.returncode,
                     "axis_lines": seen, "wall_s": time.perf_counter() - t0}
    log(f"[mesh] 20e dryrun: {DRYRUN_RANKS} gloo ranks on the one card, "
        f"exit {proc.returncode}, axis lines {seen}, "
        f"{rec['dryrun']['wall_s']:.1f} s | {smi}")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert all(v == DRYRUN_RANKS for v in seen.values()), seen
    part("e", t0)
    rec["phase_s"] = time.perf_counter() - t_phase


# ---- phase 21: K2 for any traced residual (ROADMAP Queue 2, K2-c): the
# residual families generated from the traced function
# (ops/residual_codegen.py) in K2's one-instance-a-thread kernel ----

GEN_TURNS = 2                # 21c: rounds of (fused, cg, cg, fused) a fit
#: the float64 least cost of each phase-7 curve (seed 5), by residual name,
#: filled by phase 7 and read by phase 21's gate
CURVE_F64 = {}


def curve_options(to, solver="cg"):
    """The curve fits' options (phase 7): 100 iterations, no failure
    budget; on "fused" also the envelope's save_last / carry_system off."""
    if solver == "fused":
        return to.Options(max_iters=100, max_consec_failures=0,
                          hessian=to.HessianOptions(solver="fused",
                                                    save_last=False,
                                                    carry_system=False))
    return to.Options(max_iters=100, max_consec_failures=0,
                      hessian=to.HessianOptions(solver=solver))


def suite_residuals():
    """The residuals of the JAX package's fused suite that only a
    generated family takes, with their options and starts: the
    Huber-whitened prior (tests/test_fused.py:90-108), a residual closed
    over constants with no data (:183-191), dict parameters (:194-211), the
    2-color banded residual (:445-474, LM) and the banded residual with
    data (:137-150, the dogleg).  Each maker takes (B, dtype, generator,
    device) and returns (x0, data or None)."""
    from tinyopt_tpu_torch.losses.robust_norms import huber, robust_whiten
    from tinyopt_tpu_torch.models.problems import PriorProblem

    def robust_prior(x, data):
        r = (x - data.y) * data.inv_std
        return torch.func.vmap(
            lambda ri: robust_whiten(ri[None], huber, 0.5))(r)

    def no_data(x):
        return torch.stack([x[0] * x[0] - 2.0, 0.5 * (x[0] - 1.0)])

    def dict_params(x, data):
        return torch.cat([x["a"] - data["ta"], 2.0 * (x["b"] - data["tb"])])

    def banded(x):
        return torch.cat([x[:-1] - 0.5 * x[1:], x - 1.0])

    def banded_data(x, y):
        return torch.cat([x[:-1] + 0.5 * x[1:], x[-1:]]) - y

    def rnd(B, n, dtype, g, dev):
        return torch.randn((B, n), generator=g, dtype=dtype, device=dev)

    return {
        "robust_prior": (robust_prior, {}, lambda B, dt, g, dev: (
            rnd(B, 6, dt, g, dev), PriorProblem(
                rnd(B, 6, dt, g, dev),
                1.0 / (0.1 + torch.rand((B, 6), generator=g, dtype=dt,
                                        device=dev))))),
        "no_data": (no_data, {}, lambda B, dt, g, dev: (
            torch.linspace(0.5, 3.0, B, dtype=dt, device=dev)[:, None],
            None)),
        "dict": (dict_params, {}, lambda B, dt, g, dev: (
            {"a": rnd(B, 3, dt, g, dev), "b": rnd(B, 2, dt, g, dev)},
            {"ta": torch.ones((B, 3), dtype=dt, device=dev),
             "tb": torch.full((B, 2), 0.5, dtype=dt, device=dev)})),
        "banded": (banded, {}, lambda B, dt, g, dev: (
            1.0 + 0.3 * rnd(B, 8, dt, g, dev), None)),
        "banded_data_dl": (banded_data, {"dogleg": True},
                           lambda B, dt, g, dev: (
            torch.zeros((B, 6), dtype=dt, device=dev), rnd(B, 6, dt, g,
                                                           dev))),
    }


def suite_options(to, dogleg=False):
    """tests/test_fused.py's ``_opts`` with the fused solver."""
    return to.Options(
        max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
        min_step_norm2=1e-16, max_consec_failures=3, save_history=False,
        solver_type=to.DogLeg if dogleg else to.LevenbergMarquardt,
        hessian=to.HessianOptions(save_last=False, solver="fused",
                                  cg_iters=8, carry_system=False))


def gen_bound(out, plan, opts, itemsize):
    """Least time in ms of a generated family's K2 solve of this run's
    instances, and what sets it: the bytes (x0 and the data rows in; x, g,
    8 scalars an instance and the history rows out) over the memory rate,
    or the least operations over the peak rate — for each instance's outer
    iterations (``num_iters``) the residual, g by one vjp, diag(JᵀJ) by its
    jvps (one a color, or one a tangent dimension without a coloring),
    unless the coloring makes the step closed form one PCG solve of
    ``cg_iters`` steps of a jvp and a vjp (the dogleg one more of each for
    gᵀHg), and on manifold parameters (P > D) the retraction; the
    operations of each function are the emitter's counts
    (``GeneratedFamily.ops``).  Retried proposals are not counted."""
    gen = plan.generated
    B = out.num_iters.shape[0]
    d, ops = gen.d, gen.ops
    col = plan.coloring
    n_jvp = d if col is None else (1 if col.identity else col.n_colors)
    closed = col is not None and col.n_colors == 1
    cg = opts.hessian.cg_iters or d
    per_iter = (ops["residual"] + ops["vjp"] + n_jvp * ops["jvp"]
                + (0 if closed else cg * (ops["jvp"] + ops["vjp"]))
                + (ops["retract"] if gen.p > d else 0))
    if opts.solver_type.name == "DOGLEG":
        per_iter += ops["jvp"] + ops["vjp"]
    t_ops = (float(out.num_iters.double().sum()) * per_iter
             / PEAK_FLOPS[itemsize] * 1e3)
    cap = opts.max_iters + 1 if opts.save_history else 0
    t_bytes = ((2 * gen.p + d + gen.q + 8) * B * itemsize
               + B * cap * (2 * itemsize + 1)) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase21(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """K2 for any traced residual (generated families, ROADMAP Queue 2,
    K2-c).  21a: every family the phase runs is planned (traced and
    emitted) and its library built, all nvcc runs started together; the
    build's seconds and each kernel's ptxas registers and spills
    (k2_bench.ptxas_generated).  21b: phase 7's robust curve fits (10,000
    curves of 60 points, float32, seed 5) through batched_optimize with
    solver="fused" — least squares, Huber, and Geman-McClure from the Huber
    fit — each one generated K2 launch and no K1 launch; every curve's cost
    within 1e-5 of the float64 least cost (phase 7's gate); each held to
    the twin on the card per instance (same stop reason, iterations within
    1, x within rtol 1e-5).  21c: solves/s of each fit on "fused" against
    phase 7's "cg" path, in turns (fused, cg, cg, fused) on fresh curves.
    21d: the JAX fused suite's residuals that need a generated family
    (suite_residuals) at 10,000 instances in float32 and float64, through
    batched_optimize (one generated K2 launch, no K1) and against the twin
    (float64 x within 1e-10).  Every line names the card and its power
    limit."""
    import k2_bench
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import _build
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.models import curve_fit
    from tinyopt_tpu_torch.ops import residual_codegen
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    smi = record["nvidia_smi"]
    rec = record["gen"] = {"card": smi}
    gen = torch.Generator(device=dev).manual_seed(21)
    CurveData = curve_fit.CurveData

    def reset():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        cuda_solver.fused_solve.generated_launches = 0

    def launches(key):
        n = path_launches[key] = {
            "K1": cuda_cg.cg_solve.launches,
            "K2": cuda_solver.fused_solve.launches,
            "K2 generated": cuda_solver.fused_solve.generated_launches}
        return n

    def example(x0, data):
        return (pytree.tree_map(lambda a: a[0], x0),
                None if data is None else pytree.tree_map(lambda a: a[0],
                                                          data))

    def planned(fn, opts, x0, data):
        x_ex, d_ex = example(x0, data)
        plan, why = cuda_solver.fused_envelope(
            opts, "residuals", x_ex, residual_fn=fn, data_example=d_ex)
        assert plan is not None and plan.generated is not None, why
        return plan

    def instance(plan, opts):
        kind = cuda_solver.coloring_kind(plan.coloring)
        return (plan.generated, _build.GenInstance(
            "float" if plan.spec.dtype == torch.float32 else "double",
            opts.solver_type == to.DogLeg, opts.save_history,
            cuda_solver.COLORING_CODES[kind]))

    def hold(fn, opts, x, out, x0, data, plan, what, rtol):
        """The path's result against the twin on the same inputs: equal
        stop reasons, iterations within 1, x within rtol; returns (max
        |x - x_twin|, bit-equal, the twin's seconds)."""
        xf = mf.flatten_batch(x0, plan.spec)
        xk = mf.flatten_batch(x, plan.spec)
        t0 = time.perf_counter()
        xt, ot = cuda_solver.fused_solve_plain(fn, opts, xf, data, plan)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        assert torch.equal(out.stop_reason, ot.stop_reason), what
        gap = (out.num_iters - ot.num_iters).abs().max().item()
        assert gap <= 1, f"{what}: iteration gap {gap}"
        torch.testing.assert_close(xk, xt, rtol=rtol, atol=rtol,
                                   msg=f"{what}: x against the twin")
        bits = bool(torch.equal(xk, xt) and torch.equal(out.num_iters,
                                                        ot.num_iters))
        return (xk - xt).abs().max().item(), bits, twin_s

    # ---- 21a: plan every cell, build every library together ----
    t0 = time.perf_counter()
    cdata, cx0 = curve_fit.make_curve_batch(BATCH, seed=5, device=dev)
    c_opts = curve_options(to, "fused")
    curve_fns = {"ls": curve_fit.exp_residuals,
                 "huber": curve_fit.huber_residuals,
                 "gm": curve_fit.geman_mcclure_residuals}
    c_plans = {k: planned(fn, c_opts, cx0, cdata)
               for k, fn in curve_fns.items()}
    suite = suite_residuals()
    cells = {}
    for name, (fn, kw, make) in suite.items():
        for dtype in (torch.float32, torch.float64):
            x0, data = make(BATCH, dtype, gen, dev)
            opts = suite_options(to, **kw)
            cells[(name, dtype)] = (fn, opts, x0, data,
                                    planned(fn, opts, x0, data))
    rec["plan_s"] = time.perf_counter() - t0
    # the sources traced on the card against traces of CPU copies
    on_cpu = functools.partial(pytree.tree_map, lambda a: a.cpu())
    same = 0
    for fn, x0, data, plan in ([(curve_fns[k], cx0, cdata, p)
                                for k, p in c_plans.items()]
                               + [(c[0], c[2], c[3], c[4])
                                  for c in cells.values()]):
        x_ex, d_ex = example(x0, data)
        fam, _ = residual_codegen.generated_family(
            fn, on_cpu(x_ex), None if d_ex is None else on_cpu(d_ex))
        same += fam is not None and fam.hash == plan.generated.hash
    rec["hashes"] = [p.generated.hash for p in c_plans.values()] + [
        c[4].generated.hash for c in cells.values()]
    rec["same_source_as_cpu_trace"] = same
    log(f"[curves_fused] sources traced on the card equal to a trace of "
        f"CPU copies: {same} of {len(rec['hashes'])}")
    items = ([instance(p, c_opts) for p in c_plans.values()]
             + [instance(c[4], c[1]) for c in cells.values()])
    t0 = time.perf_counter()
    libs = _build.build_generated(items)
    rec["build_s"] = time.perf_counter() - t0
    rec["libraries"] = len(set(libs))
    log(f"[curves_fused] {smi}: {len(items)} cells planned (traced, "
        f"emitted) in {rec['plan_s']:.2f} s; {rec['libraries']} generated "
        f"libraries built in {rec['build_s']:.2f} s (one nvcc each, all "
        f"together)")
    ptxas = {}
    for ln in k2_bench.ptxas_se3(k2_bench.ptxas_generated(_build, libs[:3]),
                                 keep=lambda n: True):
        lib, rest = ln.split(" ", 1)
        ptxas[lib] = rest
    rec["ptxas"] = {k: ptxas.get(os.path.basename(libs[i]))
                    for i, k in enumerate(curve_fns)}
    for k, v in rec["ptxas"].items():
        log(f"[curves_fused] ptxas {k} (float32, LM, history, no coloring): "
            f"{v[v.rindex('{'):] if v else v}")

    # ---- 21b: the curve fits through batched_optimize, "fused" ----
    fits, rec["curves"] = {}, {}
    for key, fn in curve_fns.items():
        start = cx0 if key != "gm" else fits["huber"][0]
        reset()
        x, out = to.batched_optimize(start, fn, c_opts, data_batch=cdata)
        torch.cuda.synchronize()
        n = launches(f"curve_{key}_fused")
        log(f"[curves_fused] {key}: launches {n}")
        assert n == {"K1": 0, "K2": 1, "K2 generated": 1}, (key, n)
        assert x.shape == (BATCH, 2) and bool(torch.all(torch.isfinite(x)))
        assert bool(torch.all(out.succeeded())), key
        fits[key] = (x, out)
        name7 = {"ls": "curve_ls_cg", "huber": "curve_huber_cg",
                 "gm": "curve_gm_cg"}[key]
        if name7 not in CURVE_F64:       # phase 7 did not run: its solve
            x7 = cx0.double() if key != "gm" else CURVE_F64["x_huber"]
            x64, out64 = to.batched_optimize(
                x7, fn, curve_options(to, "cholesky"),
                data_batch=CurveData(*(a.double() for a in cdata)))
            CURVE_F64[name7] = out64.final_cost.cost
            if key == "huber":
                CURVE_F64["x_huber"] = x64
        best = CURVE_F64[name7]
        gap = ((out.final_cost.cost.double() - best) / best).abs().max().item()
        assert gap < 1e-5, f"{key}: cost {gap} from the float64 solve"
        err, bits, twin_s = hold(fn, c_opts, x, out, start, cdata,
                                 c_plans[key], f"curves {key}", 1e-5)
        params = cuda_solver.k2_params(cuda_solver.GENERATED, c_opts,
                                       c_plans[key])
        xf = mf.flatten_batch(start, c_plans[key].spec)
        ms = gpu_ms(lambda: cuda_solver.fused_solve(  # noqa: B023
            fn, c_opts, xf, cdata, c_plans[key], params), n=3)
        bound, by = gen_bound(out, c_plans[key], c_opts, 4)
        stops = torch.bincount(out.stop_reason.clamp(min=0)).tolist()
        r = rec["curves"][key] = {
            "launches": n, "max_cost_gap_to_f64": gap, "max_abs_err": err,
            "bit_equal": bits, "ms": ms, "plain_ms": twin_s * 1e3,
            "bound_ms": bound, "bound_by": by, "share": bound / ms,
            "mean_iters": out.num_iters.float().mean().item(),
            "stops": stops, "ops": c_plans[key].generated.ops}
        log(f"[curves_fused] {key} {BATCH}x60 float32 ({smi}): cost gap to "
            f"the float64 solve {gap:.3e}; against the twin max|x - x_twin| "
            f"{err:.3e} (bit-equal: {bits}), stops {stops}, iterations "
            f"mean {r['mean_iters']:.2f}; kernel {ms:.4f} ms, twin "
            f"{twin_s * 1e3:.1f} ms; bound {bound:.5f} ms ({by}), share "
            f"{bound / ms:.5f}")

    # ---- 21c: solves/s on "fused" against "cg", in turns ----
    cg_opts = curve_options(to)
    cex = CurveData(cdata.t[0], cdata.y[0])
    rec["turns"] = {}
    for key, fn in curve_fns.items():
        solvers = {s: to.batched_solver(fn, o, "auto", cx0[0], cex)
                   for s, o in (("fused", c_opts), ("cg", cg_opts))}
        ms = {"fused": [], "cg": []}
        for rep in range(GEN_TURNS):
            d_rep, x_rep = curve_fit.make_curve_batch(BATCH, seed=2100 + rep,
                                                      device=dev)
            if key == "gm":      # from the Huber fit of this rep's curves
                x_rep, _ = to.batched_optimize(
                    x_rep, curve_fit.huber_residuals, c_opts,
                    data_batch=d_rep)
            for side in ("fused", "cg", "cg", "fused"):
                (_, out), t = timed(
                    lambda: solvers[side](x_rep, d_rep))  # noqa: B023
                ms[side].append(t)
        r = rec["turns"][key] = {
            side: {"ms": v, "solves_per_s": len(v) * BATCH / (sum(v) / 1e3)}
            for side, v in ms.items()}
        log(f"[curves_fused] {key} ({smi}): fused "
            f"{r['fused']['solves_per_s']:.1f} solves/s (ms {v_fmt(ms['fused'])}), "
            f"cg {r['cg']['solves_per_s']:.1f} solves/s (ms "
            f"{v_fmt(ms['cg'])}), in turns (fused, cg, cg, fused) x "
            f"{GEN_TURNS}, the solver built once a side")

    # ---- 21d: the JAX fused suite's residuals, float32 and float64 ----
    rec["suite"] = {}
    for (name, dtype), (fn, opts, x0, data, plan) in cells.items():
        tag = "" if dtype == torch.float32 else "_f64"
        reset()
        x, out = to.batched_optimize(x0, fn, opts, data_batch=data)
        torch.cuda.synchronize()
        n = launches(f"gen_{name}{tag}")
        assert n == {"K1": 0, "K2": 1, "K2 generated": 1}, (name, n)
        assert all(bool(torch.all(torch.isfinite(a)))
                   for a in pytree.tree_leaves(x)), name
        what = f"suite {name} {dtype}"
        err, bits, twin_s = hold(fn, opts, x, out, x0, data, plan, what,
                                 1e-5 if dtype == torch.float32 else 1e-10)
        params = cuda_solver.k2_params(cuda_solver.GENERATED, opts, plan)
        tables = (cuda_solver.color_tables(plan.coloring, dtype, dev)
                  if cuda_solver.coloring_kind(plan.coloring) == "multi"
                  else None)
        xf = mf.flatten_batch(x0, plan.spec)
        ms = gpu_ms(lambda: cuda_solver.fused_solve(  # noqa: B023
            fn, opts, xf, data, plan, params, tables), n=3)
        bound, by = gen_bound(out, plan, opts, xf.element_size())
        stops = torch.bincount(out.stop_reason.clamp(min=0)).tolist()
        rec["suite"][name + tag] = {
            "launches": n, "max_abs_err": err, "bit_equal": bits, "ms": ms,
            "plain_ms": twin_s * 1e3, "bound_ms": bound, "bound_by": by,
            "share": bound / ms, "stops": stops,
            "coloring": cuda_solver.coloring_kind(plan.coloring),
            "d": plan.generated.d, "n_res": plan.generated.n_res}
        log(f"[generated] {name} {BATCH} instances {dtype} ({smi}; d "
            f"{plan.generated.d}, n_res {plan.generated.n_res}, coloring "
            f"{cuda_solver.coloring_kind(plan.coloring)}): launches {n}; "
            f"max|x - x_twin| {err:.3e} (bit-equal: {bits}), stops {stops}; "
            f"kernel {ms:.4f} ms, twin {twin_s * 1e3:.1f} ms; bound "
            f"{bound:.5f} ms ({by}), share {bound / ms:.5f}")
    rec["max_abs_err"] = max(
        [v["max_abs_err"] for v in rec["curves"].values()]
        + [v["max_abs_err"] for v in rec["suite"].values()])


# ---- phase 22: K2 on manifold parameters (ROADMAP Queue 2, K2-b): the
# generated families traced through the retraction (SO3, SE3, SE23 and
# SEn3 leaves, a batched SO3 leaf, a {SE3, bias} pytree, the robust
# point-to-point SE3 fit) in K2's one-instance-a-thread kernel ----

MF_TURNS = 2                 # 22b: rounds of (fused, cg, cg, fused) a cell
MF_OUTLIERS = 3              # icp_huber: targets displaced of each instance's 16
MF_TH = 0.05                 # icp_huber: the Huber threshold on a point's distance


def manifold_residuals():
    """Phase 22's residuals on manifold parameters, each with its
    (P, D, n_res) and a maker of (x0, data) from (B, dtype, generator,
    device): the JAX fused suite's SE3 pose prior (tests/test_fused.py:317-
    319) and its {SE3, bias} pytree (:350-351), one batched SO3 leaf of 4
    rotations (an anchor prior and the 4 relative-rotation logs of a
    cycle), (prior⁻¹ @ X).log() on SE23 and on SEn3 (n = 2), the priors'
    and the relative rotations' inverses as data, and the
    point-to-point SE3 fit (models/icp.icp_residual) on the flagship's
    points and targets (make_se3_refinement at 16 points), with Huber
    whitening at ``MF_TH`` and ``MF_OUTLIERS`` targets of each instance
    displaced by 0.5·N(0, 1), and without it on the clean targets."""
    from tinyopt_tpu_torch.manifolds import SE3, SE23, SO3, SEn3
    from tinyopt_tpu_torch.models.icp import icp_residual
    from tinyopt_tpu_torch.models.se3_refinement import (SE3RefinementData,
                                                         make_se3_refinement)

    def se3_prior(T, d):
        q_inv, t_inv = d
        return (SE3(SO3(q_inv), t_inv) @ T).log()

    def se3_bias(x, d):
        return torch.cat([x["T"].log(), 2.0 * (x["bias"] - d)])

    def so3_cycle(R, d):
        # d: the anchor's and the relative rotations' inverses; R_i⁻¹ as
        # the conjugate, as tests/torch_manifold_cases.py writes it for
        # the JAX kernel
        anchor_inv, rel_inv = d
        w = R.wxyz
        w_inv = torch.cat([w[:, :1], -w[:, 1:]], -1)
        first = (SO3(anchor_inv) @ SO3(w[0])).log()
        step = SO3(w_inv) @ SO3(torch.cat([w[1:], w[:1]]))
        return torch.cat([first, (SO3(rel_inv) @ step).log().reshape(-1)])

    def se23_prior(X, d):
        return (SE23(SO3(d[0]), d[1], d[2]) @ X).log()

    def sen3_prior(X, d):
        return (SEn3(SO3(d[0]), d[1]) @ X).log()

    def icp_huber(T, d):
        return icp_residual(T, d.points, d.targets, robust_th=MF_TH)

    def icp_plain(T, d):
        return icp_residual(T, d.points, d.targets)

    def rn(B, shape, dt, g, dev, s=1.0):
        return s * torch.randn((B,) + shape, generator=g, dtype=dt,
                               device=dev)

    def icp_data(robust):
        def make(B, dt, g, dev):
            data, x0, _ = make_se3_refinement(B, 16, dtype=dt, generator=g,
                                              device=dev)
            tgt = data.targets
            if robust:
                tgt = torch.cat([tgt[:, :MF_OUTLIERS] + rn(
                    B, (MF_OUTLIERS, 3), dt, g, dev, 0.5),
                    tgt[:, MF_OUTLIERS:]], 1)
            return x0, SE3RefinementData(data.points, tgt)
        return make

    def prior(cls, n):
        def make(B, dt, g, dev):
            p = cls.exp(rn(B, (n,), dt, g, dev, 0.3)).inverse()
            x0 = cls.exp(rn(B, (n,), dt, g, dev, 0.2))
            parts = ((p.rotation.wxyz, p.velocity, p.position)
                     if cls is SE23 else (p.rotation.wxyz, p.vectors))
            return x0, parts
        return make

    def se3_prior_make(B, dt, g, dev):
        inv = SE3.exp(rn(B, (6,), dt, g, dev, 0.4)).inverse()
        return (SE3.exp(rn(B, (6,), dt, g, dev, 0.2)),
                (inv.rotation.wxyz, inv.translation))

    return {
        "se3_prior": (se3_prior, (7, 6, 6), se3_prior_make),
        "se3_bias": (se3_bias, (9, 8, 8), lambda B, dt, g, dev: (
            {"T": SE3.exp(rn(B, (6,), dt, g, dev, 0.1)),
             "bias": rn(B, (2,), dt, g, dev)}, rn(B, (2,), dt, g, dev))),
        "so3_cycle": (so3_cycle, (16, 12, 15), lambda B, dt, g, dev: (
            SO3.exp(rn(B, (4, 3), dt, g, dev, 0.3)),
            (SO3.exp(rn(B, (3,), dt, g, dev, 0.2)).inverse().wxyz,
             SO3.exp(rn(B, (4, 3), dt, g, dev, 0.3)).inverse().wxyz))),
        "se23_prior": (se23_prior, (10, 9, 9), prior(SE23, 9)),
        "sen3_prior": (sen3_prior, (10, 9, 9), prior(SEn3, 9)),
        "icp_huber": (icp_huber, (7, 6, 48), icp_data(True)),
        "icp_plain": (icp_plain, (7, 6, 48), icp_data(False)),
    }


# The least arithmetic phase 22's cells need (flops; a multiply and an add
# count one each, a square root, sine, cosine, arctangent or division one),
# whatever way a kernel computes it.  Parts on SE_n(3), n vectors beside the
# rotation (0 for SO3, 1 for SE3, 2 for SE23 and SEn3 at n = 2): a product
# 28 + 33n (quaternions 28; a vector rotated by a unit quaternion 30 and
# added 3); the log 12 (SO3's: the vector part's norm 6, atan2 1, the scale
# 5) + 6 + 30n (V(ω)⁻¹ on each vector: two cross products and a blend, its
# coefficients once); the retraction 41 (exp 13, a product 28) + 6 + 63n
# (V(ω)ρ 30, rotated 30, added 3); the Jacobian of log(A·X·exp δ) at 0,
# Jr(r)⁻¹, 30 (I + ½[ω]× + c[ω]×²) + 90n (each coupling block, two 3 × 3
# products at least).
def _sen3_flops(n):
    return dict(product=28 + 33 * n, log=12 + (6 + 30 * n if n else 0),
                retract=41 + (6 + 63 * n if n else 0), jac=30 + 90 * n)


def _mf_min_flops():
    """Each non-ICP residual of phase 22: (its residual, its Jacobian in
    closed form, the retraction, the non-zeros of each Jacobian row, the
    non-zeros of JᵀJ) in flops.  so3_cycle's relative rotation i is
    log(C_i⁻¹ R_i⁻¹ R_(i+1)): two products and a log; its Jacobian Jr(r)⁻¹
    for R_(i+1) and, for R_i, that block times the rotation matrix of R_(i+1)⁻¹
    R_i (28 from its quaternion, 45 the 3 × 3 product); each rotation
    meets its two neighbours of the cycle, so JᵀJ has 12 of its 16 3 × 3
    blocks."""
    s0, s1, s2 = (_sen3_flops(n) for n in (0, 1, 2))
    prior2 = (s2["product"] + s2["log"], s2["jac"], s2["retract"],
              (9,) * 9, 81)
    return {
        "se3_prior": (s1["product"] + s1["log"], s1["jac"], s1["retract"],
                      (6,) * 6, 36),
        "se3_bias": (s1["log"] + 4, s1["jac"], s1["retract"] + 2,
                     (6,) * 6 + (1,) * 2, 38),
        "so3_cycle": (s0["product"] + s0["log"]
                      + 4 * (2 * s0["product"] + s0["log"]),
                      s0["jac"] + 4 * (s0["jac"] + 28 + 45),
                      4 * s0["retract"], (3,) * 3 + (6,) * 12, 108),
        "se23_prior": prior2, "sen3_prior": prior2}


MF_MIN_FLOPS = _mf_min_flops()
# icp_huber beyond SE3_MIN_FLOPS, an iteration: each point's test against
# the threshold (1); each displaced point (an outlier wherever it lies
# past the threshold) its weight and the weight's gradient (14), the
# whitened residual (3), its rows (w I + r ∇wᵀ) J (111), their part of JᵀJ
# (126) and of g (36).  The clean points' weights are not counted.
HUBER_MIN_FLOPS = dict(point=1, outlier=290)


def mf_bound(name, out, plan, opts, itemsize):
    """Least time in ms of one of phase 22's K2 solves on the card for this
    run's instances, and what sets it: the bytes (x0 and the data in; x, g
    and 8 scalars an instance out) over the memory rate, or the least
    operations over the peak rate.  The ICP cells are the SE3 solve
    (``k2_se3_bound``, ``SE3_MIN_FLOPS``), icp_huber with its weights
    (``HUBER_MIN_FLOPS`` an iteration); each other cell's outer iterations
    (``num_iters``) count ``MF_MIN_FLOPS``' residual, Jacobian and
    retraction, g = Jᵀr and JᵀJ over the rows' non-zeros, the cost, one
    PCG solve of ``cg_iters`` steps (D when 0) on JᵀJ's non-zeros and the
    dogleg's 110 (``SE3_MIN_FLOPS``).  Retried proposals are not counted.
    Not the emitter's counts (``gen_bound``): those count a jvp a tangent
    dimension, the PCG's jvps and vjps and both sides of every select."""
    dogleg = opts.solver_type.name == "DOGLEG"
    if name.startswith("icp_"):
        h = HUBER_MIN_FLOPS
        return k2_se3_bound(out, opts, SE3_K, itemsize, dogleg, extra=(
            0 if name == "icp_plain"
            else SE3_K * h["point"] + MF_OUTLIERS * h["outlier"]))
    gen = plan.generated
    B, d, n_res = out.num_iters.shape[0], gen.d, gen.n_res
    residual, jac, retract, rows, h_nz = MF_MIN_FLOPS[name]
    cg = opts.hessian.cg_iters or d
    per_iter = (residual + jac + 2 * sum(rows)
                + sum(k * (k + 1) for k in rows) + 2 * n_res
                + cg * (2 * h_nz + 11 * d) + retract
                + (SE3_MIN_FLOPS["dogleg"] if dogleg else 0))
    t_ops = (float(out.num_iters.double().sum()) * per_iter
             / PEAK_FLOPS[itemsize] * 1e3)
    t_bytes = ((2 * gen.p + d + gen.q + 8) * B * itemsize
               / HBM_BYTES_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: phase 22's cells: (residual, dtype, the dogleg)
MF_CELLS = (("se3_prior", torch.float32, False),
            ("se3_prior", torch.float64, False),
            ("se3_prior", torch.float32, True),
            ("se3_bias", torch.float32, False),
            ("se3_bias", torch.float64, False),
            ("so3_cycle", torch.float32, False),
            ("so3_cycle", torch.float64, False),
            ("se23_prior", torch.float32, False),
            ("se23_prior", torch.float64, False),
            ("sen3_prior", torch.float32, False),
            ("icp_huber", torch.float32, False),
            ("icp_plain", torch.float32, False))


def phase22(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """K2 on manifold parameters (generated families traced through the
    retraction, ROADMAP Queue 2, K2-b), 10,000 instances a cell at
    ``bench_se3``'s options on "fused" (``MF_CELLS``, the residuals of
    ``manifold_residuals``).  22a: every cell planned (traced, emitted)
    and its library built, all nvcc runs started together; each library's
    ptxas registers, stack and spills.  22b: each cell through
    the fused solver of batched_solver (built from 22a's plan) — one
    generated K2 launch, no K1 and no K2 warp launch — held to the twin on
    the card per instance (the twins run while nvcc builds; equal stop
    reasons, iterations within 1, x within rtol 1e-5 in float32 and 1e-10
    in float64; bit-equal or not), the kernel's and the twin's times and
    the least bound (mf_bound; the emitter's, gen_bound, beside it);
    icp_huber succeeds on at least 99 % of its instances.  22c: se3_prior, icp_huber and icp_plain, "fused" against
    "cg" solves/s in turns (fused, cg, cg, fused).  22d: icp_plain's
    generated kernel against se3_residual's hand-written one
    (solver_se3_kernel) on identical inputs, in turns.  Every line names
    the card and its power limit."""
    import k2_bench
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import _build
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.models.se3_refinement import se3_residual
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    smi = record["nvidia_smi"]
    rec = record["mf"] = {"card": smi}
    gen = torch.Generator(device=dev).manual_seed(22)
    cases = manifold_residuals()

    def reset():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        cuda_solver.fused_solve.generated_launches = 0

    def example(x0, data):
        return (pytree.tree_map(lambda a: a[0], x0),
                pytree.tree_map(lambda a: a[0], data))

    # ---- 22a: plan every cell, build every library together ----
    t0 = time.perf_counter()
    cells, items = {}, []
    for name, dtype, dogleg in MF_CELLS:
        fn, widths, make = cases[name]
        x0, data = make(BATCH, dtype, gen, dev)
        opts = se3_options(to, **({"solver_type": to.DogLeg} if dogleg
                                  else {}))
        x_ex, d_ex = example(x0, data)
        plan, why = cuda_solver.fused_envelope(
            opts, "residuals", x_ex, residual_fn=fn, data_example=d_ex)
        assert plan is not None and plan.generated is not None, why
        g_ = plan.generated
        assert (g_.p, g_.d, g_.n_res) == widths, (name, g_.p, g_.d, g_.n_res)
        key = (name + ("_dl" if dogleg else "")
               + ("" if dtype == torch.float32 else "_f64"))
        cells[key] = (fn, opts, x0, data, plan)
        items.append((g_, _build.GenInstance(
            "float" if dtype == torch.float32 else "double", dogleg,
            opts.save_history, cuda_solver.COLORING_CODES[
                cuda_solver.coloring_kind(plan.coloring)])))
    rec["plan_s"] = time.perf_counter() - t0

    def build():
        t = time.perf_counter()
        return _build.build_generated(items), time.perf_counter() - t

    # the twins on the card while nvcc builds the libraries
    twins = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build)
        for key, (fn, opts, x0, data, plan) in cells.items():
            t0 = time.perf_counter()
            xt, ot = cuda_solver.fused_solve_plain(
                fn, opts, mf.flatten_batch(x0, plan.spec), data, plan)
            torch.cuda.synchronize()
            twins[key] = (xt, ot, time.perf_counter() - t0)
        libs, rec["build_s"] = building.result()
    log(f"[manifold] {smi}: {len(items)} cells planned (traced through the "
        f"retraction, emitted) in {rec['plan_s']:.2f} s; {len(set(libs))} "
        f"generated libraries built in {rec['build_s']:.2f} s (one nvcc "
        f"each, all together, while the twins ran)")
    ptxas = {}
    for ln in k2_bench.ptxas_se3(k2_bench.ptxas_generated(_build, libs),
                                 keep=lambda n: True):
        lib, rest = ln.split(" ", 1)
        ptxas[lib] = rest[rest.index("{"):]
    rec["ptxas"] = {k: ptxas.get(os.path.basename(lib))
                    for k, lib in zip(cells, libs)}

    # ---- 22b: each cell through the fused solver batched_solver builds
    # (from 22a's plan: no second trace), against the twin ----
    rec["cells"] = {}
    for key, (fn, opts, x0, data, plan) in cells.items():
        solve = cuda_solver.fused_batched_solver(fn, opts, *example(x0, data),
                                                 plan=plan)
        reset()
        x, out = solve(x0, data)
        torch.cuda.synchronize()
        path_launches[f"mf_{key}"] = {
            "K1": cuda_cg.cg_solve.launches,
            "K2": cuda_solver.fused_solve.launches,
            "K2 generated": cuda_solver.fused_solve.generated_launches}
        n = path_launches[f"mf_{key}"]
        assert n == {"K1": 0, "K2": 1, "K2 generated": 1, "K2 warp": 0}, (
            key, n)
        assert all(bool(torch.all(torch.isfinite(a)))
                   for a in pytree.tree_leaves(x)), key
        xf = mf.flatten_batch(x0, plan.spec)
        xk = mf.flatten_batch(x, plan.spec)
        xt, ot, twin_s = twins[key]
        assert torch.equal(out.stop_reason, ot.stop_reason), key
        gap = (out.num_iters - ot.num_iters).abs().max().item()
        assert gap <= 1, f"{key}: iteration gap {gap}"
        rtol = 1e-5 if xf.dtype == torch.float32 else 1e-10
        torch.testing.assert_close(xk, xt, rtol=rtol, atol=rtol,
                                   msg=f"{key}: x against the twin")
        bits = bool(torch.equal(xk, xt)
                    and torch.equal(out.num_iters, ot.num_iters))
        err = (xk - xt).abs().max().item()
        succ = out.succeeded().float().mean().item()
        if key.startswith("icp_huber"):
            assert succ >= 0.99, f"{key}: succeeded on {succ}"
        params = cuda_solver.k2_params(cuda_solver.GENERATED, opts, plan)
        ms = gpu_ms(lambda: cuda_solver.fused_solve(  # noqa: B023
            fn, opts, xf, data, plan, params), n=3)
        bound, by = mf_bound(key.removesuffix("_f64").removesuffix("_dl"),
                             out, plan, opts, xf.element_size())
        ebound, eby = gen_bound(out, plan, opts, xf.element_size())
        stops = torch.bincount(out.stop_reason.clamp(min=0)).tolist()
        g_ = plan.generated
        rec["cells"][key] = {
            "launches": n, "max_abs_err": err, "bit_equal": bits, "ms": ms,
            "plain_ms": twin_s * 1e3, "bound_ms": bound, "bound_by": by,
            "share": bound / ms, "emitter_bound_ms": ebound,
            "emitter_bound_by": eby, "stops": stops, "succeeded": succ,
            "mean_iters": out.num_iters.float().mean().item(),
            "P": g_.p, "D": g_.d, "n_res": g_.n_res, "ops": g_.ops,
            "coloring": cuda_solver.coloring_kind(plan.coloring),
            "ptxas": rec["ptxas"][key]}
        log(f"[manifold] {key} {BATCH} instances ({smi}; P {g_.p}, D "
            f"{g_.d}, n_res {g_.n_res}, coloring "
            f"{cuda_solver.coloring_kind(plan.coloring)}): launches {n}; "
            f"max|x - x_twin| {err:.3e} (bit-equal: {bits}), stops {stops}, "
            f"succeeded {succ:.4f}, iterations mean "
            f"{rec['cells'][key]['mean_iters']:.2f}; kernel {ms:.4f} ms, "
            f"twin {twin_s * 1e3:.1f} ms; bound {bound:.6f} ms ({by}), "
            f"share {bound / ms:.6f}; the emitter's counts {ebound:.5f} ms "
            f"({eby}); ptxas {rec['ptxas'][key]}")

    # ---- 22c: solves/s on "fused" against "cg", in turns ----
    rec["turns"] = {}
    for key in ("se3_prior", "icp_huber", "icp_plain"):
        fn, opts, x0, data, plan = cells[key]
        x_ex, d_ex = example(x0, data)
        solvers = {s: to.batched_solver(fn, o, "auto", x_ex, d_ex)
                   for s, o in (("fused", opts),
                                ("cg", se3_options(to, "cg")))}
        ms = {"fused": [], "cg": []}
        for _ in range(MF_TURNS):
            for side in ("fused", "cg", "cg", "fused"):
                _, t = timed(lambda: solvers[side](x0, data))  # noqa: B023
                ms[side].append(t)
        r = rec["turns"][key] = {
            side: {"ms": v, "solves_per_s": len(v) * BATCH / (sum(v) / 1e3)}
            for side, v in ms.items()}
        log(f"[manifold] {key} ({smi}): fused "
            f"{r['fused']['solves_per_s']:.1f} solves/s (ms "
            f"{v_fmt(ms['fused'])}), cg {r['cg']['solves_per_s']:.1f} "
            f"solves/s (ms {v_fmt(ms['cg'])}), in turns (fused, cg, cg, "
            f"fused) x {MF_TURNS}, the solver built once a side")

    # ---- 22d: icp_plain's generated kernel against the hand-written SE3
    # kernel (se3_residual, the same map) on identical inputs ----
    fn, opts, x0, data, plan = cells["icp_plain"]
    x_ex, d_ex = example(x0, data)
    hplan = cuda_solver.fused_plan(opts, "residuals", x_ex,
                                   residual_fn=se3_residual,
                                   data_example=d_ex)
    assert hplan is not None and hplan.generated is None
    xf = mf.flatten_batch(x0, plan.spec)
    sides = {
        "generated": lambda: cuda_solver.fused_solve(fn, opts, xf, data,
                                                     plan),
        "hand": lambda: cuda_solver.fused_solve(se3_residual, opts, xf, data,
                                                hplan)}
    xg, og = sides["generated"]()
    xh, oh = sides["hand"]()
    torch.cuda.synchronize()
    hand_err = (xg - xh).abs().max().item()
    same_stop = (og.stop_reason == oh.stop_reason).float().mean().item()
    torch.testing.assert_close(xg, xh, rtol=1e-4, atol=1e-5,
                               msg="icp_plain against se3_residual's kernel")
    t = {"generated": [], "hand": []}
    for _ in range(MF_TURNS):
        for side in ("generated", "hand", "hand", "generated"):
            t[side].append(gpu_ms(sides[side], n=3))
    rec["icp_plain_vs_hand"] = {"ms": t, "max_abs_diff": hand_err,
                                "same_stop_share": same_stop}
    log(f"[manifold] icp_plain {BATCH}x16 float32 ({smi}): generated kernel "
        f"ms {t['generated']}, hand-written solver_se3_kernel ms "
        f"{t['hand']}, in turns; max|x_gen - x_hand| "
        f"{hand_err:.3e}, same stop reason on {same_stop:.4f}")
    rec["max_abs_err"] = max(v["max_abs_err"] for v in rec["cells"].values())


# ---- phase 23: K2's warp kernel on generated families past max(P, D,
# n_res) = 64 (ROADMAP Queue 2, K2-a): the residual, its jvp and its vjp
# emitted for one warp (ops/residual_codegen.py's warp form) in
# csrc/solver_warp.cuh's solver_kernel, with its multi-color branch ----

WIDE_POINTS = 128            # ICP's points a pair (phase 14)
WIDE_OUTLIERS = 24           # icp_huber: phase 22's 3 of 16, scaled to 128
WIDE_ICP_B = 4096            # ICP's pairs (phase 14)
WIDE_D = 128                 # the banded residual's width
WIDE_SAMPLES = 256           # the Huber curve fit's samples
WIDE_HOLD = 1024             # instances of a cell the twin is held on
WIDE_TURNS = 2               # 23c / 23d: rounds of (a, b, b, a)
#: phase 23's cells: (residual, dtype, the dogleg)
WIDE_CELLS = (("icp_huber", torch.float32, False),
              ("icp_huber", torch.float64, False),
              ("icp_plain", torch.float32, False),
              ("banded", torch.float32, False),
              ("banded", torch.float64, False),
              ("banded", torch.float32, True),
              ("banded_off", torch.float32, False),
              ("curve_huber", torch.float32, False))


def wide_residuals():
    """Phase 23's residuals, each with its (P, D, n_res), its options'
    maker and a maker of (x0, data) from (dtype, generator, device): the
    point-to-point SE3 fit (models/icp.icp_residual) on the flagship's
    points at ICP's 128 a pair, with Huber whitening at ``MF_TH`` and
    ``WIDE_OUTLIERS`` targets of each pair displaced by 0.5·N(0, 1), and
    without it on the clean targets; the JAX suite's banded residual with
    data (tests/test_fused.py:143-144) at d = 128 from x = 0, its 2-color
    coloring on ("banded") and off ("banded_off"); phase 7's Huber curve
    fit at 256 samples."""
    from tinyopt_tpu_torch.models import curve_fit
    from tinyopt_tpu_torch.models.icp import icp_residual
    from tinyopt_tpu_torch.models.se3_refinement import (SE3RefinementData,
                                                         make_se3_refinement)

    def icp_huber(T, d):
        return icp_residual(T, d.points, d.targets, robust_th=MF_TH)

    def icp_plain(T, d):
        return icp_residual(T, d.points, d.targets)

    def banded(x, y):
        return torch.cat([x[:-1] + 0.5 * x[1:], x[-1:]]) - y

    def icp_data(robust):
        def make(dt, g, dev):
            data, x0, _ = make_se3_refinement(WIDE_ICP_B, WIDE_POINTS,
                                              dtype=dt, generator=g,
                                              device=dev)
            tgt = data.targets
            if robust:
                tgt = torch.cat([tgt[:, :WIDE_OUTLIERS] + 0.5 * torch.randn(
                    (WIDE_ICP_B, WIDE_OUTLIERS, 3), generator=g, dtype=dt,
                    device=dev), tgt[:, WIDE_OUTLIERS:]], 1)
            return x0, SE3RefinementData(data.points, tgt)
        return make

    def banded_data(dt, g, dev):
        return (torch.zeros((BATCH, WIDE_D), dtype=dt, device=dev),
                torch.randn((BATCH, WIDE_D), generator=g, dtype=dt,
                            device=dev))

    def curve_data(dt, g, dev):
        data, x0 = curve_fit.make_curve_batch(BATCH, n=WIDE_SAMPLES, seed=23,
                                              dtype=dt, device=dev)
        return x0, data

    def off(to, **kw):
        o = se3_options(to, **kw)
        return dataclasses.replace(o, hessian=dataclasses.replace(
            o.hessian, diag_coloring="off"))

    n = 3 * WIDE_POINTS
    return {
        "icp_huber": (icp_huber, (7, 6, n), se3_options, icp_data(True)),
        "icp_plain": (icp_plain, (7, 6, n), se3_options, icp_data(False)),
        "banded": (banded, (WIDE_D,) * 3, se3_options, banded_data),
        "banded_off": (banded, (WIDE_D,) * 3, off, banded_data),
        "curve_huber": (curve_fit.huber_residuals, (2, 2, WIDE_SAMPLES),
                        lambda to, **kw: curve_options(to, "fused"),
                        curve_data),
    }


#: phase 23's cells planned and their libraries building, started by
#: ``phase23_prepare`` right after the package's build
WIDE_PREP = {}


def phase23_prepare(to, dev, cuda_solver):
    """Plan phase 23's cells on the card (traced, the warp form emitted)
    and start building their libraries in the background, one nvcc each,
    all together at a lower priority, so the builds run beside phases
    3–22; fills ``WIDE_PREP``."""
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import _build
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(23)
    cases = wide_residuals()
    cells, items = {}, []
    for name, dtype, dogleg in WIDE_CELLS:
        fn, widths, options, make = cases[name]
        x0, data = make(dtype, gen, dev)
        opts = options(to, **({"solver_type": to.DogLeg} if dogleg else {}))
        x_ex, d_ex = (pytree.tree_map(lambda a: a[0], x0),
                      pytree.tree_map(lambda a: a[0], data))
        plan, why = cuda_solver.fused_envelope(
            opts, "residuals", x_ex, residual_fn=fn, data_example=d_ex)
        assert plan is not None and plan.generated is not None, why
        g_ = plan.generated
        assert (g_.p, g_.d, g_.n_res) == widths and g_.warp, (name, widths)
        kind = cuda_solver.coloring_kind(plan.coloring)
        if name == "banded":
            assert kind == "multi" and plan.coloring.n_colors == 2, kind
        key = (name + ("_dl" if dogleg else "")
               + ("" if dtype == torch.float32 else "_f64"))
        cells[key] = (fn, opts, x0, data, plan)
        items.append((g_, cuda_solver.generated_instance(
            g_, dtype, dogleg, opts.save_history, kind)))
    plan_s = time.perf_counter() - t0

    def build():
        t = time.perf_counter()
        return _build.build_generated(items, nice=10), \
            time.perf_counter() - t
    pool = concurrent.futures.ThreadPoolExecutor(1)
    WIDE_PREP.update(cells=cells, items=items, plan_s=plan_s,
                     building=pool.submit(build))
    pool.shutdown(wait=False)
    log(f"[wide] {len(cells)} cells planned in {plan_s:.2f} s; their "
        f"{len(items)} warp libraries building in the background")


def phase23(to, dev, record, path_launches, cuda_cg, cuda_solver):
    """K2's warp kernel on generated families past max(P, D, n_res) = 64
    (ROADMAP Queue 2, K2-a), the cells of ``WIDE_CELLS``
    (``wide_residuals``): the robust point-to-point SE3 fit at ICP's 128
    points a pair (4,096 pairs, 384 residuals; the headline) and without
    Huber, the banded residual at d = 128 (10,000; the multi-color branch,
    2 colors, and "off"), the Huber curve fit at 256 samples (10,000), at
    ``bench_se3``'s options on "fused" (the curve fit at phase 7's).  23a:
    every cell planned (traced, the warp form emitted) on the warp path and
    its library built, all nvcc runs started together right after the
    package's build (``phase23_prepare``); the twins on each cell's first
    ``WIDE_HOLD`` instances; each library's ptxas registers, stack and
    spills.  23b: each cell through the fused solver
    of batched_solver (built from 23a's plan) twice — one generated K2
    launch on the warp kernel, no K1, the two runs' outputs equal — held to
    the twin per instance on the first ``WIDE_HOLD`` (equal stop reasons,
    iterations within 1, x within rtol 1e-5 in float32 and 1e-10 in
    float64; bit-equal or not), the kernel's time on the batch and on the
    held instances, the twin's, and the least bound (``k2_se3_bound`` at
    128 points for the ICP cells, with the displaced points' Huber weights
    for icp_huber; ``gen_bound`` for the rest) with the share; icp_huber
    succeeds on at least 99 % of its pairs.  23c: icp_plain's generated
    kernel against se3_residual's hand-written warp form (``SE3Family``,
    the same map) on identical inputs, in turns.  23d: icp_huber and the
    banded residual, "fused" against "cg" solves/s in turns.  Every line
    names the card and its power limit."""
    import k2_bench
    from torch.utils import _pytree as pytree
    from tinyopt_tpu_torch import _build
    from tinyopt_tpu_torch import manifold as mf
    from tinyopt_tpu_torch.models.se3_refinement import se3_residual
    from tinyopt_tpu_torch.output import map_output
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off"
    smi = record["nvidia_smi"]
    rec = record["wide"] = {"card": smi}

    def reset():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        cuda_solver.fused_solve.generated_launches = 0

    def example(x0, data):
        return (pytree.tree_map(lambda a: a[0], x0),
                pytree.tree_map(lambda a: a[0], data))

    def head(t, n=WIDE_HOLD):
        return pytree.tree_map(lambda a: a[:n].contiguous(), t)

    # ---- 23a: every cell planned and its library built (started by
    # phase23_prepare, else here) ----
    if not WIDE_PREP:
        phase23_prepare(to, dev, cuda_solver)
    cells, items = WIDE_PREP["cells"], WIDE_PREP["items"]
    rec["plan_s"] = WIDE_PREP["plan_s"]
    # the twins on the card, on each cell's held instances, while nvcc
    # builds the libraries (if it still does)
    twins = {}
    for key, (fn, opts, x0, data, plan) in cells.items():
        t0 = time.perf_counter()
        xt, ot = cuda_solver.fused_solve_plain(
            fn, opts, head(mf.flatten_batch(x0, plan.spec)), head(data),
            plan)
        torch.cuda.synchronize()
        twins[key] = (xt, ot, time.perf_counter() - t0)
    t0 = time.perf_counter()
    libs, rec["build_s"] = WIDE_PREP["building"].result()
    rec["build_wait_s"] = time.perf_counter() - t0
    log(f"[wide] {smi}: {len(items)} cells planned (traced, the warp form "
        f"emitted) in {rec['plan_s']:.2f} s; {len(set(libs))} warp "
        f"libraries built in {rec['build_s']:.2f} s (one nvcc each, all "
        f"together, at a lower priority beside phases 3-22), waited for "
        f"{rec['build_wait_s']:.2f} s after the twins")
    ptxas = {}
    for ln in k2_bench.ptxas_se3(k2_bench.ptxas_generated(_build, libs),
                                 keep=lambda n: True):
        lib, rest = ln.split(" ", 1)
        ptxas[lib] = rest[rest.index("{"):]
    rec["ptxas"] = {k: ptxas.get(os.path.basename(lib))
                    for k, lib in zip(cells, libs)}

    # ---- 23b: each cell through the fused solver batched_solver builds
    # (from 23a's plan), twice, against the twin ----
    rec["cells"] = {}
    for key, (fn, opts, x0, data, plan) in cells.items():
        solve = cuda_solver.fused_batched_solver(fn, opts, *example(x0, data),
                                                 plan=plan)
        reset()
        x, out = solve(x0, data)
        torch.cuda.synchronize()
        path_launches[f"wide_{key}"] = {
            "K1": cuda_cg.cg_solve.launches,
            "K2": cuda_solver.fused_solve.launches,
            "K2 generated": cuda_solver.fused_solve.generated_launches}
        n = path_launches[f"wide_{key}"]
        assert n == {"K1": 0, "K2": 1, "K2 generated": 1, "K2 warp": 1}, (
            key, n)
        x2, out2 = solve(x0, data)
        torch.cuda.synchronize()
        xf = mf.flatten_batch(x0, plan.spec)
        xk = mf.flatten_batch(x, plan.spec)
        same = all(torch.equal(a, b) for a, b in (
            (xk, mf.flatten_batch(x2, plan.spec)),
            (out.num_iters, out2.num_iters),
            (out.stop_reason, out2.stop_reason),
            (out.final_cost.cost, out2.final_cost.cost),
            (out.final_grad, out2.final_grad)))
        assert same, f"{key}: two runs of the kernel differ"
        # the outputs' bytes, to hold one run of the script to another
        digest = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in (
                xk, out.num_iters, out.stop_reason, out.final_cost.cost,
                out.final_grad))).hexdigest()[:16]
        assert all(bool(torch.all(torch.isfinite(a)))
                   for a in pytree.tree_leaves(x)), key
        xt, ot, twin_s = twins[key]
        xh, oh = head(xk), map_output(head, out)
        assert torch.equal(oh.stop_reason, ot.stop_reason), key
        gap = (oh.num_iters - ot.num_iters).abs().max().item()
        assert gap <= 1, f"{key}: iteration gap {gap}"
        rtol = 1e-5 if xf.dtype == torch.float32 else 1e-10
        torch.testing.assert_close(xh, xt, rtol=rtol, atol=rtol,
                                   msg=f"{key}: x against the twin")
        bits = bool(torch.equal(xh, xt)
                    and torch.equal(oh.num_iters, ot.num_iters)
                    and torch.equal(oh.final_cost.cost, ot.final_cost.cost))
        err = (xh - xt).abs().max().item()
        succ = out.succeeded().float().mean().item()
        if key.startswith("icp_huber"):
            assert succ >= 0.99, f"{key}: succeeded on {succ}"
        params = cuda_solver.k2_params(cuda_solver.GENERATED, opts, plan)
        ms = gpu_ms(lambda: cuda_solver.fused_solve(  # noqa: B023
            fn, opts, xf, data, plan, params), n=2)
        xfh, dh = head(xf), head(data)
        ms_hold = gpu_ms(lambda: cuda_solver.fused_solve(  # noqa: B023
            fn, opts, xfh, dh, plan, params), n=2)
        itemsize = xf.element_size()
        if key.startswith("icp"):
            h = HUBER_MIN_FLOPS
            bound, by = k2_se3_bound(out, opts, WIDE_POINTS, itemsize, extra=(
                0 if key.startswith("icp_plain") else
                WIDE_POINTS * h["point"] + WIDE_OUTLIERS * h["outlier"]))
        else:
            bound, by = gen_bound(out, plan, opts, itemsize)
        stops = torch.bincount(out.stop_reason.clamp(min=0)).tolist()
        g_ = plan.generated
        kp = cuda_solver.k2_launch_plan(
            xf.shape[0], g_.d, g_.n_res, itemsize, cuda_solver.GENERATED,
            cuda_solver.coloring_kind(plan.coloring), params.solver, g_.p,
            g_.scratch)
        rec["cells"][key] = {
            "launches": n, "max_abs_err": err, "bit_equal": bits,
            "runs_equal": same, "digest": digest, "B": xf.shape[0],
            "ms": ms,
            "ms_hold": ms_hold, "hold": WIDE_HOLD, "plain_ms": twin_s * 1e3,
            "bound_ms": bound, "bound_by": by, "share": bound / ms,
            "stops": stops, "succeeded": succ,
            "mean_iters": out.num_iters.float().mean().item(),
            "P": g_.p, "D": g_.d, "n_res": g_.n_res, "ops": g_.ops,
            "scratch": g_.scratch, "plan": kp._asdict(),
            "coloring": cuda_solver.coloring_kind(plan.coloring),
            "n_colors": getattr(plan.coloring, "n_colors", None),
            "ptxas": rec["ptxas"][key]}
        log(f"[wide] {key} {xf.shape[0]} instances ({smi}; P {g_.p}, D "
            f"{g_.d}, n_res {g_.n_res}, coloring "
            f"{cuda_solver.coloring_kind(plan.coloring)} "
            f"({rec['cells'][key]['n_colors']} colors), scratch {g_.scratch}"
            f" values, plan {kp}): launches {n}; two runs equal (outputs "
            f"{digest}); max|x - "
            f"x_twin| {err:.3e} on the first {WIDE_HOLD} (bit-equal: {bits}),"
            f" stops {stops}, succeeded {succ:.4f}, iterations mean "
            f"{rec['cells'][key]['mean_iters']:.2f}; kernel {ms:.4f} ms "
            f"({ms_hold:.4f} on the first {WIDE_HOLD}), twin "
            f"{twin_s * 1e3:.1f} ms on those; bound {bound:.6f} ms ({by}), "
            f"share {bound / ms:.6f}; ptxas {rec['ptxas'][key]}")

    # ---- 23c: icp_plain's generated kernel against the hand-written SE3
    # family's warp form (se3_residual, the same map) on identical inputs
    fn, opts, x0, data, plan = cells["icp_plain"]
    x_ex, d_ex = example(x0, data)
    hplan = cuda_solver.fused_plan(opts, "residuals", x_ex,
                                   residual_fn=se3_residual,
                                   data_example=d_ex)
    assert hplan is not None and hplan.generated is None
    xf = mf.flatten_batch(x0, plan.spec)
    sides = {
        "generated": lambda: cuda_solver.fused_solve(fn, opts, xf, data,
                                                     plan),
        "hand": lambda: cuda_solver.fused_solve(se3_residual, opts, xf, data,
                                                hplan)}
    reset()
    xg, og = sides["generated"]()
    xh, oh = sides["hand"]()
    torch.cuda.synchronize()
    assert cuda_solver.fused_solve.warp_launches == 2
    hand_err = (xg - xh).abs().max().item()
    same_stop = (og.stop_reason == oh.stop_reason).float().mean().item()
    torch.testing.assert_close(xg, xh, rtol=1e-4, atol=1e-5,
                               msg="icp_plain against SE3Family")
    t = {"generated": [], "hand": []}
    for _ in range(WIDE_TURNS):
        for side in ("generated", "hand", "hand", "generated"):
            t[side].append(gpu_ms(sides[side], n=2))
    rec["icp_plain_vs_hand"] = {"ms": t, "max_abs_diff": hand_err,
                                "same_stop_share": same_stop}
    log(f"[wide] icp_plain {WIDE_ICP_B}x{WIDE_POINTS} float32 ({smi}): "
        f"generated warp kernel ms {t['generated']}, hand-written SE3Family "
        f"warp kernel ms {t['hand']}, in turns; max|x_gen - x_hand| "
        f"{hand_err:.3e}, same stop reason on {same_stop:.4f}")

    # ---- 23d: solves/s on "fused" against "cg", in turns ----
    rec["turns"] = {}
    for key in ("icp_huber", "banded"):
        fn, opts, x0, data, plan = cells[key]
        x_ex, d_ex = example(x0, data)
        solvers = {s: to.batched_solver(fn, o, "auto", x_ex, d_ex)
                   for s, o in (("fused", opts),
                                ("cg", se3_options(to, "cg")))}
        ms = {"fused": [], "cg": []}
        B = x0.shape[0] if isinstance(x0, torch.Tensor) else WIDE_ICP_B
        for _ in range(WIDE_TURNS):
            for side in ("fused", "cg", "cg", "fused"):
                _, t_ = timed(lambda: solvers[side](x0, data))  # noqa: B023
                ms[side].append(t_)
        r = rec["turns"][key] = {
            side: {"ms": v, "solves_per_s": len(v) * B / (sum(v) / 1e3)}
            for side, v in ms.items()}
        log(f"[wide] {key} ({smi}): fused {r['fused']['solves_per_s']:.1f} "
            f"solves/s (ms {v_fmt(ms['fused'])}), cg "
            f"{r['cg']['solves_per_s']:.1f} solves/s (ms {v_fmt(ms['cg'])}),"
            f" in turns (fused, cg, cg, fused) x {WIDE_TURNS}, the solver "
            f"built once a side")
    rec["max_abs_err"] = max(v["max_abs_err"] for v in rec["cells"].values())


def v_fmt(ms):
    return "[" + ", ".join(f"{m:.2f}" for m in ms) + "]"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from torch.utils import _pytree as pytree
    import tinyopt_tpu_torch as to
    from tinyopt_tpu_torch import _build
    from tinyopt_tpu_torch.models import curve_fit
    from tinyopt_tpu_torch.models.problems import (jennrich_sampson_residuals,
                                                   make_prior_batch,
                                                   powell_singular_residuals,
                                                   prior_residual,
                                                   wood_residuals)
    from tinyopt_tpu_torch.models.se3_refinement import (make_se3_refinement,
                                                         se3_residual)
    from tinyopt_tpu_torch.ops import cuda_cg, cuda_solver
    from tinyopt_tpu_torch.ops.linalg import solve_psd_cg

    t_main = time.perf_counter()
    dev = torch.device("cuda", 0)
    record = {"python": sys.version.split()[0], "torch": torch.__version__,
              "cuda": torch.version.cuda}
    # seconds of each part of the run, each printed as it ends
    part_s = record["phase_s"] = {}
    t_mark = [t_main]

    def mark(name):
        now = time.perf_counter()
        part_s[name] = now - t_mark[0]
        t_mark[0] = now
        log(f"[time] {name} {part_s[name]:.1f} s")

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()} | nvidia-smi: {smi}")
    record["nvidia_smi"] = smi

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.load()
    record["build_s"] = time.perf_counter() - t0
    log(f"[build] {_build.library_path()} built and loaded in "
        f"{record['build_s']:.2f} s")
    # phase 23's generated libraries build in the background from here
    phase23_prepare(to, dev, cuda_solver)
    mark("build")

    # ---- 3. K1 against its twin ----
    gen = torch.Generator(device=dev).manual_seed(0)

    def spd(B, d, dtype):
        A = torch.randn((B, 2 * d, d), generator=gen, dtype=dtype,
                        device=dev) / (2 * d) ** 0.5
        H = A.mT @ A + 1e-3 * torch.eye(d, dtype=dtype, device=dev)
        b = torch.randn((B, d), generator=gen, dtype=dtype, device=dev)
        return H, b

    # Tolerance on max|x_k - x_twin|, relative to max|x| (CG's rounding
    # error is spread over all components, so it is not elementwise): the
    # kernel's column sums (fused multiply-adds), warp and block reductions
    # sum in another order than the twin's batched matmul, so the iterates
    # agree to rounding, amplified by cond(H) over the iterations — not bit
    # for bit.
    k1_tol = {torch.float32: 1e-5, torch.float64: 1e-11}
    k1 = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.float64):
        H, b = spd(BATCH, DIMS, dtype)
        plan = cuda_cg.k1_launch_plan(BATCH, DIMS, H.element_size(),
                                      H.data_ptr())
        log(f"[K1] plan {dtype}: {plan}")
        for iters in (8, 50):
            xk = cuda_cg.cg_solve(H, b, iters)
            xt = solve_psd_cg(H, b, iters)
            torch.cuda.synchronize()
            err = (xk - xt).abs().max().item()
            scale = xt.abs().max().item()
            log(f"[K1] {BATCH}x{DIMS}x{DIMS} {dtype} iters={iters}: "
                f"max|x_k - x_twin| = {err:.3e} (max|x| {scale:.3e})")
            assert err <= k1_tol[dtype] * max(1.0, scale), "K1 disagrees"
            if iters == 8:
                k1[f"ms_{dtype}"] = gpu_ms(lambda: cuda_cg.cg_solve(H, b, 8),
                                          n=20)
                k1[f"plain_ms_{dtype}"] = gpu_ms(
                    lambda: solve_psd_cg(H, b, 8), n=5)
                k1[f"bound_ms_{dtype}"], k1[f"bound_by_{dtype}"] = k1_bound(
                    BATCH, DIMS, 8, H.element_size())
                k1[f"share_{dtype}"] = (k1[f"bound_ms_{dtype}"]
                                        / k1[f"ms_{dtype}"])
                log(f"[K1] time {dtype}: kernel {k1[f'ms_{dtype}']:.4f} ms, "
                    f"twin {k1[f'plain_ms_{dtype}']:.4f} ms per call; "
                    f"bound {k1[f'bound_ms_{dtype}']:.4f} ms "
                    f"({k1[f'bound_by_{dtype}']}), share "
                    f"{k1[f'share_{dtype}']:.3f}")
                if dtype == torch.float32:
                    k1["max_abs_err"] = err
    # alpha-freeze: H = 0 has p'Hp = 0 at every iteration, x stays 0
    H, b = spd(257, DIMS, torch.float32)
    H[::2] = 0
    xk = cuda_cg.cg_solve(H, b, 8)
    xt = solve_psd_cg(H, b, 8)
    assert torch.all(xk[::2] == 0) and torch.all(xt[::2] == 0), "K1 freeze"
    torch.testing.assert_close(xk, xt, rtol=1e-5, atol=1e-5)
    log("[K1] alpha-freeze (H = 0) and ragged B = 257: ok")
    # Each edge is held against the float64 twin on the same inputs:
    # float64 to 1e-11 of max|x|; float32 to twice the float32 twin's own
    # gap, or 1e-5 of max|x| where that is larger — at d = 9, 8 iterations
    # run CG to exhaustion, where float32 iterates are rounding noise, twin
    # and kernel alike.  Returns the worst error over the limit.
    def k1_edge(H, b, iters):
        x64 = solve_psd_cg(H.double(), b.double(), iters)
        scale = max(1.0, x64.abs().max().item())
        twin_gap = (solve_psd_cg(H, b, iters).double()
                    - x64).abs().max().item()
        limit = (max(2 * twin_gap, 1e-5 * scale)
                 if H.dtype == torch.float32 else 1e-11 * scale)
        worst = 0.0
        for Hk in (H, offset_view(H)):
            err = (cuda_cg.cg_solve(Hk, b, iters).double()
                   - x64).abs().max().item()
            worst = max(worst, err / limit)
        return worst

    # the warp kernel's edges: per-value copies (an instance of 324 or 676
    # bytes; a view one element past an aligned base), lanes without a
    # second column (d <= 32), an odd d with a second column (33: padded
    # rows in float64), two full columns (d = 64), B below the warps of a
    # block, at 8 iterations
    for dtype in (torch.float32, torch.float64):
        for B, d in ((257, 9), (257, 13), (257, 33), (3, 50), (257, 50),
                     (257, 64)):
            H, b = spd(B, d, dtype)
            plan = cuda_cg.k1_launch_plan(B, d, H.element_size(),
                                          H.data_ptr())
            worst = k1_edge(H, b, 8)
            log(f"[K1] {B}x{d}x{d} {dtype} {plan.path}/{plan.h_in}/"
                f"{plan.copy}: max|x_k - x_f64| / limit = {worst:.3f}, "
                "aligned and offset")
            assert worst <= 1.0, "K1 edge shape"
    # the block kernel (d > 64): every way its plan reads H — the whole
    # column in registers (to d = 128 in float32, 96 in float64), 64 rows
    # of it with the rest from shared memory (above), and from device
    # memory (d = 300, and float64 at 200) — aligned (one bulk copy) and
    # offset (per-value copies), B = 1, 3, 257, at 8 and at d iterations
    for dtype in (torch.float32, torch.float64):
        for d in (65, 96, 97, 128, 129, 200, 300):
            worst, ways = 0.0, set()
            for B in (1, 3, 257):
                H, b = spd(B, d, dtype)
                ways.add(cuda_cg.k1_launch_plan(B, d, H.element_size(),
                                                H.data_ptr()).h_in)
                for iters in (8, d):
                    worst = max(worst, k1_edge(H, b, iters))
            log(f"[K1] block d = {d} {dtype} ({'/'.join(sorted(ways))}), "
                f"B = 1, 3, 257, 8 and {d} iterations, aligned and offset: "
                f"max|x_k - x_f64| / limit = {worst:.3f}")
            assert worst <= 1.0, f"K1 block kernel at d = {d}"
    # past 1024 threads: d = 1024 reads H from device memory a thread a
    # column; d = 1100 and 2100 run the wide kernel (two and three columns
    # a thread, their state in shared memory), as do d = 6000 in float32
    # and 4500 in float64 (six and five), at 8 iterations, aligned and
    # offset
    for dtype, wide in ((torch.float32, 6000), (torch.float64, 4500)):
        for d, Bs in ((1024, (1, 3)), (1100, (1, 3)), (2100, (1, 3)),
                      (wide, (1,))):
            worst = 0.0
            for B in Bs:
                H, b = spd(B, d, dtype)
                plan = cuda_cg.k1_launch_plan(B, d, H.element_size(),
                                              H.data_ptr())
                worst = max(worst, k1_edge(H, b, 8))
                del H, b
            torch.cuda.empty_cache()
            log(f"[K1] block d = {d} {dtype} ({plan.h_in}, {plan.cols} "
                f"columns a thread), B = {Bs}, 8 iterations, aligned and "
                f"offset: max|x_k - x_f64| / limit = {worst:.3f}")
            assert worst <= 1.0, f"K1 block kernel at d = {d}"
    # alpha-freeze on the block kernel (H = 0 in every other instance), and
    # more instances than blocks resident at once (the persistent stride)
    for dtype in (torch.float32, torch.float64):
        H, b = spd(257, 96, dtype)
        H[::2] = 0
        xk = cuda_cg.cg_solve(H, b, 96)
        assert torch.all(xk[::2] == 0), "K1 block freeze"
        assert k1_edge(H, b, 96) <= 1.0, "K1 block freeze"
        H, b = spd(10_007, 96, dtype)
        worst = k1_edge(H, b, 8)
        log(f"[K1] block {dtype}: alpha-freeze at d = 96 ok; 10007x96x96, 8 "
            f"iterations: max|x_k - x_f64| / limit = {worst:.3f}")
        assert worst <= 1.0, "K1 block kernel, persistent stride"
    # the block kernel timed at the shapes of k1_bench.py: d = 65 at d
    # iterations; d = 100, H in shared memory; d = 300, H read from device
    # memory; d = 2100, the wide kernel
    for B, d, iters in ((1000, 65, 65), (256, 100, 20), (64, 300, 20),
                        (8, 2100, 20)):
        for dtype, tag in ((torch.float32, ""), (torch.float64, "_f64")):
            H, b = spd(B, d, dtype)
            xt = solve_psd_cg(H, b, iters)
            err = (cuda_cg.cg_solve(H, b, iters) - xt).abs().max().item()
            scale = xt.abs().max().item()
            assert err <= k1_tol[dtype] * max(1.0, scale), f"K1 at d = {d}"
            key = f"blk_d{d}"
            k1[f"{key}_h_in{tag}"] = cuda_cg.k1_launch_plan(
                B, d, H.element_size(), H.data_ptr()).h_in
            k1[f"{key}_ms{tag}"] = gpu_ms(
                lambda: cuda_cg.cg_solve(H, b, iters), n=20)
            k1[f"{key}_plain_ms{tag}"] = gpu_ms(
                lambda: solve_psd_cg(H, b, iters), n=3)
            k1[f"{key}_bound_ms{tag}"], k1[f"{key}_bound_by{tag}"] = \
                k1_bound(B, d, iters, H.element_size())
            k1[f"{key}_share{tag}"] = (k1[f"{key}_bound_ms{tag}"]
                                       / k1[f"{key}_ms{tag}"])
            k1[f"{key}_max_abs_err{tag}"] = err
            log(f"[K1] {B}x{d}x{d} {dtype} iters={iters} "
                f"({k1[f'{key}_h_in{tag}']}): kernel "
                f"{k1[f'{key}_ms{tag}']:.4f} ms, twin "
                f"{k1[f'{key}_plain_ms{tag}']:.4f} ms; bound "
                f"{k1[f'{key}_bound_ms{tag}']:.4f} ms "
                f"({k1[f'{key}_bound_by{tag}']}), share "
                f"{k1[f'{key}_share{tag}']:.3f}; max|x_k - x_twin| "
                f"{err:.3e} (max|x| {scale:.3e})")

    # K1 on the flagship's cg path (10k systems of d = 6) and on the curve
    # fits' (d = 2): cg_iters 0, so d iterations (the tangent dimension)
    for d, dtype in ((6, torch.float32), (6, torch.float64),
                     (2, torch.float32), (2, torch.float64)):
        H, b = spd(BATCH, d, dtype)
        xk = cuda_cg.cg_solve(H, b, d)
        xt = solve_psd_cg(H, b, d)
        err = (xk - xt).abs().max().item()
        scale = xt.abs().max().item()
        assert err <= k1_tol[dtype] * max(1.0, scale), f"K1 at d = {d}"
        tag = "" if dtype == torch.float32 else "_f64"
        k1[f"d{d}_ms{tag}"] = gpu_ms(lambda: cuda_cg.cg_solve(H, b, d), n=20)
        k1[f"d{d}_plain_ms{tag}"] = gpu_ms(lambda: solve_psd_cg(H, b, d), n=5)
        k1[f"d{d}_bound_ms{tag}"], k1[f"d{d}_bound_by{tag}"] = k1_bound(
            BATCH, d, d, H.element_size())
        k1[f"d{d}_share{tag}"] = (k1[f"d{d}_bound_ms{tag}"]
                                  / k1[f"d{d}_ms{tag}"])
        k1[f"d{d}_max_abs_err{tag}"] = err
        plan = cuda_cg.k1_launch_plan(BATCH, d, H.element_size(),
                                      H.data_ptr())
        log(f"[K1] {BATCH}x{d}x{d} {dtype} iters={d} ({plan}"
            f"): max|x_k - x_twin| = {err:.3e} (max|x| {scale:.3e}); kernel "
            f"{k1[f'd{d}_ms{tag}']:.4f} ms, twin "
            f"{k1[f'd{d}_plain_ms{tag}']:.4f} ms; bound "
            f"{k1[f'd{d}_bound_ms{tag}']:.4f} ms "
            f"({k1[f'd{d}_bound_by{tag}']}), share "
            f"{k1[f'd{d}_share{tag}']:.3f}")

    mark("k1")

    # ---- 4. K2 against its twin ----
    def k2_pair(fn, opts, x0, data=None):
        d_ex = None if data is None else type(data)(*(a[0] for a in data))
        plan = cuda_solver.fused_plan(opts, "residuals", x0[0],
                                      residual_fn=fn, data_example=d_ex)
        assert plan is not None, "outside the fused envelope"
        kern = lambda: cuda_solver.fused_solve(  # noqa: E731
            fn, opts, x0, data, plan)
        plain = lambda: cuda_solver.fused_solve_plain(  # noqa: E731
            fn, opts, x0, data, plan)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        return got, ref, kern, plain

    def k2_plan(x0, n_res, family, coloring):
        plan = cuda_solver.k2_launch_plan(x0.shape[0], x0.shape[1], n_res,
                                          x0.element_size(), family,
                                          coloring)
        return (f"{plan.path} S={plan.S} E={plan.E} warps={plan.warps} "
                f"grid<={plan.grid}")

    k2 = {}
    # float64 is held to rtol 1e-9, not to equality: the kernels' sums
    # follow one warp butterfly order, torch.sum its own, so the two may
    # differ in the last bits (on these inputs they agree exactly).
    k2_tol = {torch.float32: dict(rtol=1e-5, atol=1e-6),
              torch.float64: dict(rtol=1e-9, atol=1e-12)}

    def k2_check(ref, got, dtype, what, tol=None, **slack):
        """Parity with the twin, equal stop reasons, and the history rows
        (equal num_hist and successes, errs and deltas2 to the tolerance,
        0 / False past num_hist); returns max |x_k - x_twin| and the
        largest history gap."""
        tol = tol or k2_tol[dtype]
        err = assert_parity(ref, got, **tol, **slack, what=what)
        assert torch.equal(got[1].stop_reason, ref[1].stop_reason), what
        outr, outg = ref[1], got[1]
        assert outg.errs.shape == outr.errs.shape, what
        assert torch.equal(outg.num_hist, outr.num_hist), what
        assert torch.equal(outg.successes, outr.successes), what
        gap = 0.0
        for a, b in ((outg.errs, outr.errs), (outg.deltas2, outr.deltas2)):
            torch.testing.assert_close(a, b, **tol, msg=what)
            if a.numel():
                gap = max(gap, (a - b).abs().max().item())
        past = (torch.arange(outg.errs.shape[1], device=dev)[None, :]
                >= outg.num_hist[:, None])
        assert bool(torch.all(outg.errs[past] == 0)), what
        assert not bool(torch.any(outg.successes[past])), what
        return err, gap
    for dtype in (torch.float32, torch.float64):
        data, x0 = make_prior_batch(BATCH, DIMS, dtype, generator=gen,
                                    device=dev)
        opts = bench_options(to)
        log(f"[K2] plan prior {BATCH}x{DIMS} {dtype}: "
            f"{k2_plan(x0, DIMS, 0, 'identity')}")
        got, ref, kern, plain = k2_pair(prior_residual, opts, x0, data)
        err = assert_parity(ref, got, **k2_tol[dtype],
                            what=f"K2 prior {dtype}")
        conv = got[1].converged().float().mean().item()
        log(f"[K2] prior {BATCH}x{DIMS} {dtype}: max|x_k - x_twin| = "
            f"{err:.3e}, conv {conv:.4f}, mean iters "
            f"{got[1].num_iters.float().mean().item():.3f}")
        k2[f"ms_{dtype}"] = gpu_ms(kern, n=5)
        k2[f"plain_ms_{dtype}"] = gpu_ms(plain, n=3)
        k2[f"bound_ms_{dtype}"] = k2_bound_ms(BATCH, DIMS, x0.element_size())
        k2[f"share_{dtype}"] = k2[f"bound_ms_{dtype}"] / k2[f"ms_{dtype}"]
        log(f"[K2] time {dtype}: kernel {k2[f'ms_{dtype}']:.4f} ms, twin "
            f"{k2[f'plain_ms_{dtype}']:.4f} ms per {BATCH} solves")
        if dtype == torch.float32:
            k2["max_abs_err"] = err
    for dtype in (torch.float32, torch.float64):
        x0 = (torch.rand((4096, 2), generator=gen, dtype=dtype, device=dev)
              * 0.35 + 0.1)
        opts = to.Options(
            max_iters=20, min_error=0.0, min_rerr_dec=1e-12,
            min_step_norm2=1e-16, max_consec_failures=5, save_history=False,
            hessian=to.HessianOptions(save_last=False, solver="fused",
                                      cg_iters=8, carry_system=False))
        log(f"[K2] plan Jennrich-Sampson 4096x2 {dtype}: "
            f"{k2_plan(x0, 10, 1, None)}")
        got, ref, kern, plain = k2_pair(jennrich_sampson_residuals, opts, x0)
        # ill-conditioned: tests/test_fused.py:118-126 tolerances
        err = assert_parity(ref, got, rtol=2e-3, atol=1e-3, iter_slack=2,
                            fail_slack=2, grad_rtol=2e-2,
                            what=f"K2 Jennrich-Sampson {dtype}")
        nfail = got[1].num_failures.sum().item()
        assert nfail > 0, "Jennrich-Sampson produced no rejections"
        k2[f"js_ms_{dtype}"] = gpu_ms(kern, n=5)
        # the twin's host loop takes seconds; the check above has already
        # run it on these inputs, so one more call times it
        k2[f"js_plain_ms_{dtype}"] = gpu_ms(plain, n=1, warmup=0)
        k2[f"js_bound_ms_{dtype}"], k2[f"js_bound_by_{dtype}"] = js_bound(
            got[1], 10, x0.element_size())
        k2[f"js_share_{dtype}"] = (k2[f"js_bound_ms_{dtype}"]
                                   / k2[f"js_ms_{dtype}"])
        log(f"[K2] Jennrich-Sampson 4096x2 {dtype}: max err {err:.3e}, "
            f"{nfail} rejections, stops "
            f"{torch.bincount(got[1].stop_reason.clamp(min=0)).tolist()}; "
            f"kernel {k2[f'js_ms_{dtype}']:.4f} ms, twin "
            f"{k2[f'js_plain_ms_{dtype}']:.4f} ms per 4096 solves; bound "
            f"{k2[f'js_bound_ms_{dtype}']:.5f} ms "
            f"({k2[f'js_bound_by_{dtype}']}), share "
            f"{k2[f'js_share_{dtype}']:.4f}")
    # the dogleg (closed-form GN and Levenberg steps on the prior) and LM
    # with the history rows, at the main path's shape, timed; the bytes
    # bound of the dogleg is LM's, the history adds its rows
    for dtype in (torch.float32, torch.float64):
        data, x0 = make_prior_batch(BATCH, DIMS, dtype, generator=gen,
                                    device=dev)
        for what, kw in (("dl", dict(solver_type=to.DogLeg)),
                         ("hist", dict(save_history=True))):
            opts = bench_options(to, **kw)
            got, ref, kern, plain = k2_pair(prior_residual, opts, x0, data)
            err, gap = k2_check(ref, got, dtype, f"K2 {what} prior {dtype}")
            cap = got[1].errs.shape[1]
            k2[f"{what}_ms_{dtype}"] = gpu_ms(kern, n=5)
            k2[f"{what}_plain_ms_{dtype}"] = gpu_ms(plain, n=3)
            k2[f"{what}_bound_ms_{dtype}"] = k2_bound_ms(
                BATCH, DIMS, x0.element_size(), cap)
            k2[f"{what}_share_{dtype}"] = (k2[f"{what}_bound_ms_{dtype}"]
                                           / k2[f"{what}_ms_{dtype}"])
            k2[f"{what}_max_abs_err_{dtype}"] = err
            log(f"[K2] {what} prior {BATCH}x{DIMS} {dtype} (history slots "
                f"{cap}): max|x_k - x_twin| = {err:.3e}, history gap "
                f"{gap:.3e}, mean iters "
                f"{got[1].num_iters.float().mean().item():.3f}; kernel "
                f"{k2[f'{what}_ms_{dtype}']:.4f} ms, twin "
                f"{k2[f'{what}_plain_ms_{dtype}']:.4f} ms; bound "
                f"{k2[f'{what}_bound_ms_{dtype}']:.4f} ms, share "
                f"{k2[f'{what}_share_{dtype}']:.3f}")
    # the dogleg on Jennrich-Sampson: PCG for every solve, rejections, and
    # near the singular minimum both Levenberg fallbacks
    for dtype in (torch.float32, torch.float64):
        x0 = (torch.rand((4096, 2), generator=gen, dtype=dtype, device=dev)
              * 0.35 + 0.1)
        x0[::4] = 0.2578 + (torch.rand((1024, 2), generator=gen, dtype=dtype,
                                       device=dev) - 0.5) * 2e-3
        opts = bench_options(to, solver_type=to.DogLeg, max_iters=20,
                             max_consec_failures=5)
        got, ref, kern, plain = k2_pair(jennrich_sampson_residuals, opts, x0)
        # ill-conditioned: tests/test_fused.py:118-126 tolerances
        err, _ = k2_check(ref, got, dtype, f"K2 dogleg Jennrich-Sampson "
                          f"{dtype}", tol=dict(rtol=2e-3, atol=1e-3),
                          iter_slack=2, fail_slack=2, grad_rtol=2e-2)
        nfail = got[1].num_failures.sum().item()
        k2[f"dl_js_ms_{dtype}"] = gpu_ms(kern, n=5)
        k2[f"dl_js_plain_ms_{dtype}"] = gpu_ms(plain, n=1, warmup=0)
        (k2[f"dl_js_bound_ms_{dtype}"],
         k2[f"dl_js_bound_by_{dtype}"]) = js_bound(got[1], 10,
                                                   x0.element_size(), True)
        k2[f"dl_js_share_{dtype}"] = (k2[f"dl_js_bound_ms_{dtype}"]
                                      / k2[f"dl_js_ms_{dtype}"])
        log(f"[K2] dogleg Jennrich-Sampson 4096x2 {dtype}: max err "
            f"{err:.3e}, {nfail} rejections, stops "
            f"{torch.bincount(got[1].stop_reason.clamp(min=0)).tolist()}; "
            f"kernel {k2[f'dl_js_ms_{dtype}']:.4f} ms, twin "
            f"{k2[f'dl_js_plain_ms_{dtype}']:.4f} ms per 4096 solves; bound "
            f"{k2[f'dl_js_bound_ms_{dtype}']:.5f} ms "
            f"({k2[f'dl_js_bound_by_{dtype}']}), share "
            f"{k2[f'dl_js_share_{dtype}']:.4f}")
    mark("k2_cells")
    # the edges of K2's plans: segments of 2 to 16 lanes, entries past d on
    # a segment's last lanes, the register kernel's largest d and the warp
    # kernel past it, a batch that is no multiple of a block's instances;
    # the closed-form step and PCG; LM, the dogleg and the history
    variants = (("lm", {}), ("dogleg", dict(solver_type=to.DogLeg)),
                ("history", dict(save_history=True)))
    for dtype in (torch.float32, torch.float64):
        for d in (1, 9, 16, 17, 32, 33, 50, 64, 65):
            data, x0 = make_prior_batch(257, d, dtype, generator=gen,
                                        device=dev)
            for name, kw in variants:
                if name != "lm" and d not in (1, 17, 50, 64, 65):
                    continue
                for coloring in ("auto", "off"):
                    opts = bench_options(to, **kw)
                    opts = dataclasses.replace(
                        opts, hessian=dataclasses.replace(
                            opts.hessian, diag_coloring=coloring))
                    got, ref, _, _ = k2_pair(prior_residual, opts, x0, data)
                    err, gap = k2_check(ref, got, dtype,
                                        f"K2 {name} prior 257x{d} {dtype}")
                    plan = k2_plan(x0, d, 0, 'identity' if coloring == 'auto'
                                   else None)
                    log(f"[K2] {name} prior 257x{d} {dtype} coloring "
                        f"{coloring} ({plan}): max|x_k - x_twin| = "
                        f"{err:.3e}, history gap {gap:.3e}")
    # batches smaller than a warp's segments
    for B in (1, 3):
        data, x0 = make_prior_batch(B, DIMS, torch.float32, generator=gen,
                                    device=dev)
        for name, kw in variants:
            got, ref, _, _ = k2_pair(prior_residual, bench_options(to, **kw),
                                     x0, data)
            err, _ = k2_check(ref, got, torch.float32,
                              f"K2 {name} prior {B}x{DIMS}")
            log(f"[K2] {name} prior {B}x{DIMS} float32 "
                f"({k2_plan(x0, DIMS, 0, 'identity')}): max|x_k - x_twin| = "
                f"{err:.3e}")
    # one instance with inv_std = nan: it stops with SYSTEM_HAS_NAN_OR_INF,
    # the instances beside it in its warp match the twin
    data, x0 = make_prior_batch(64, DIMS, torch.float32, generator=gen,
                                device=dev)
    data.inv_std[5, 3] = float("nan")
    got, ref, _, _ = k2_pair(prior_residual, bench_options(to), x0, data)
    assert_parity(ref, got, **k2_tol[torch.float32], what="K2 nan neighbour")
    stops = got[1].stop_reason
    assert stops[5].item() == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)
    assert torch.equal(stops, ref[1].stop_reason)
    assert bool(torch.all(torch.cat([stops[:5], stops[6:]]) > 0))
    log(f"[K2] nan neighbour: instance 5 stops {stops[5].item()}, its "
        f"neighbours {stops[:8].tolist()} as the twin's")

    mark("k2")

    # ---- 4b. K2's SE3 family (the retraction branch) against its twin:
    # the flagship's 10k x 16 in float32 and float64 with LM and the
    # dogleg, timed; K = 24 (n_res 72, the warp kernel); B = 1, 3, 257;
    # K = 3, 4, 8 and 21, every geometry launch_se3 can pick; an instance
    # whose target is NaN ----
    # the twin's wall in ms, host-synchronized, of k2_se3's last call (its
    # one run of the twin, reused as plain_ms: a second run only to time it
    # cost ~15 s of the script)
    twin_ms = {}

    def k2_se3(opts, B, K, dtype, seed, nan_at=None):
        data, xb, _ = make_se3_refinement(B, K, dtype=dtype, seed=seed,
                                          device=dev)
        if nan_at is not None:
            data.targets[nan_at, 3, 1] = float("nan")
        x_ex = pytree.tree_map(lambda a: a[0], xb)
        d_ex = type(data)(*(a[0] for a in data))
        plan = cuda_solver.fused_plan(opts, "residuals", x_ex,
                                      residual_fn=se3_residual,
                                      data_example=d_ex)
        assert plan is not None, "SE3 outside the fused envelope"
        x0 = to.manifold.flatten_batch(xb, plan.spec)
        kern = lambda: cuda_solver.fused_solve(  # noqa: E731
            se3_residual, opts, x0, data, plan)
        plain = lambda: cuda_solver.fused_solve_plain(  # noqa: E731
            se3_residual, opts, x0, data, plan)
        plain64 = lambda: cuda_solver.fused_solve_plain(  # noqa: E731
            se3_residual, opts, x0.double(),
            type(data)(*(a.double() for a in data)), plan)[0]
        got = kern()
        torch.cuda.synchronize()
        t_twin = time.perf_counter()
        ref = plain()
        torch.cuda.synchronize()
        twin_ms["last"] = (time.perf_counter() - t_twin) * 1e3
        kp = cuda_solver.k2_launch_plan(B, 6, 3 * K, x0.element_size(), 2,
                                        None, cuda_solver.SOLVER_CODES[
                                            opts.solver_type], 7)
        return got, ref, kern, plain, (f"{kp.path} S={kp.S} E={kp.E} "
                                       f"warps={kp.warps} grid<={kp.grid}"), \
            plain64

    for dtype in (torch.float32, torch.float64):
        tag = "" if dtype == torch.float32 else "_f64"
        for what, kw in (("", {}), ("dl_", dict(solver_type=to.DogLeg))):
            opts = se3_options(to, **kw)
            got, ref, kern, plain, kplan, _ = k2_se3(opts, BATCH, SE3_K,
                                                     dtype, 11)
            err, di, df = se3_check(ref, got, dtype,
                                    f"K2 SE3 {what}{SE3_CELL} {dtype}")
            out = got[1]
            conv = out.converged().float().mean().item()
            assert conv == 1.0, f"K2 SE3 {what}{dtype}: conv {conv}"
            k2[f"se3_{what}ms{tag}"] = gpu_ms(kern, n=5)
            k2[f"se3_{what}plain_ms{tag}"] = twin_ms["last"]
            (k2[f"se3_{what}bound_ms{tag}"],
             k2[f"se3_{what}bound_by{tag}"]) = k2_se3_bound(
                out, opts, SE3_K, got[0].element_size(), bool(what))
            k2[f"se3_{what}share{tag}"] = (k2[f"se3_{what}bound_ms{tag}"]
                                           / k2[f"se3_{what}ms{tag}"])
            k2[f"se3_{what}max_abs_err{tag}"] = err
            k2[f"se3_{what}mean_iters{tag}"] = (
                out.num_iters.float().mean().item())
            stops = torch.bincount(out.stop_reason.clamp(min=0)).tolist()
            log(f"[K2] SE3 {'dogleg' if what else 'LM'} {SE3_CELL} {dtype} "
                f"({kplan}): max|x_k - x_twin| = {err:.3e}, iteration gap "
                f"{di}, failure gap {df}, conv {conv:.4f}, mean iters "
                f"{out.num_iters.float().mean().item():.3f}, stops {stops}; "
                f"kernel {k2[f'se3_{what}ms{tag}']:.4f} ms, twin "
                f"{k2[f'se3_{what}plain_ms{tag}']:.4f} ms; bound "
                f"{k2[f'se3_{what}bound_ms{tag}']:.5f} ms "
                f"({k2[f'se3_{what}bound_by{tag}']}), share "
                f"{k2[f'se3_{what}share{tag}']:.3f}")
        # K2's warp kernel (solver_kernel, max(d, n_res) > 64) at 10k x 24
        # points, LM: no main path reaches it; timed for PERF.md's table
        opts = se3_options(to)
        got, ref, kern, plain, kplan, _ = k2_se3(opts, BATCH, SE3_WARP_K,
                                                 dtype, 13)
        assert kplan.startswith("warp"), kplan
        err, di, df = se3_check(ref, got, dtype,
                                f"K2 warp SE3 {BATCH}x{SE3_WARP_K} {dtype}")
        out = got[1]
        w = {"ms": gpu_ms(kern, n=5),
             "plain_ms": twin_ms["last"],
             "max_abs_err": err,
             "mean_iters": out.num_iters.float().mean().item(),
             "conv": out.converged().float().mean().item()}
        w["bound_ms"], w["bound_by"] = k2_se3_bound(
            out, opts, SE3_WARP_K, got[0].element_size())
        w["share"] = w["bound_ms"] / w["ms"]
        k2.update({f"warp_se3_{k}{tag}": v for k, v in w.items()})
        log(f"[K2] warp kernel, SE3 LM {BATCH}x{SE3_WARP_K} {dtype} "
            f"({kplan}): max|x_k - x_twin| = {err:.3e}, iteration gap {di}, "
            f"failure gap {df}, conv {w['conv']:.4f}, mean iters "
            f"{w['mean_iters']:.3f}; kernel {w['ms']:.4f} ms, twin "
            f"{w['plain_ms']:.4f} ms; bound {w['bound_ms']:.5f} ms "
            f"({w['bound_by']}), share {w['share']:.4f}")
        # one outer iteration (max_iters=0): loads, one linearization and
        # step, stores; the rest of se3_ms is the ~3 further iterations
        _, _, kern0, _, kplan0, _ = k2_se3(se3_options(to, max_iters=0),
                                           BATCH, SE3_K, dtype, 11)
        k2[f"se3_iter0_ms{tag}"] = gpu_ms(kern0, n=5)
        # the split of LM's time: the first outer iteration (with the loads
        # and stores) and each further one, from the two times and the
        # mean iterations (the clock64 split of an iteration is
        # k2_attribution.py --family se3's)
        further = k2[f"se3_mean_iters{tag}"] - 1
        k2[f"se3_iter_us{tag}"] = ((k2[f"se3_ms{tag}"]
                                    - k2[f"se3_iter0_ms{tag}"])
                                   / max(further, 1e-9) * 1e3)
        log(f"[K2] SE3 LM {SE3_CELL} {dtype} ({kplan0}) at max_iters=0: "
            f"kernel {k2[f'se3_iter0_ms{tag}']:.4f} ms; split of the LM "
            f"call: first iteration {k2[f'se3_iter0_ms{tag}']:.4f} ms, "
            f"{further:.3f} further iterations at "
            f"{k2[f'se3_iter_us{tag}']:.2f} us each")
        dl = dict(solver_type=to.DogLeg)
        # the register kernel's geometries (S lanes, 4 points a lane in
        # float32, 8 in float64): S = 1 at K = 3, 4 (and 8 in float64), S =
        # 2 at K = 8 in float32, S = 8 in float32 and 4 in float64 at K = 21
        for B, K, kw in ((257, 24, {}), (257, 24, dl), (1, SE3_K, {}),
                         (3, SE3_K, {}), (257, SE3_K, {}), (257, SE3_K, dl),
                         *((257, k, w) for k in (3, 4, 8, 21)
                           for w in ({}, dl))):
            opts = se3_options(to, **kw)
            got, ref, _, _, kplan, plain64 = k2_se3(opts, B, K, dtype,
                                                    12 + B + K)
            name = "dogleg" if kw else "LM"
            what = f"K2 SE3 {name} {B}x{K} {dtype}"
            if K == 3 and dtype == torch.float32:
                err, gap, d64 = se3_check_few(ref, got, plain64(), what)
                log(f"[K2] SE3 {name} {B}x{K} {dtype} ({kplan}): max|x_k - "
                    f"x_twin| = {err:.3e} within twice the twin's own gap "
                    f"to float64 ({gap:.3e}); max|x_k - x_f64| = {d64:.3e}")
                continue
            err, di, df = se3_check(ref, got, dtype, what)
            log(f"[K2] SE3 {name} {B}x{K} {dtype} ({kplan}): max|x_k - "
                f"x_twin| = {err:.3e}, iteration gap {di}, failure gap {df}")
        got, ref, _, _, _, _ = k2_se3(se3_options(to), 64, SE3_K, dtype, 5,
                                      nan_at=5)
        err, _, _ = se3_check(ref, got, dtype, f"K2 SE3 nan neighbour {dtype}")
        stops = got[1].stop_reason
        assert stops[5].item() == int(to.StopReason.SYSTEM_HAS_NAN_OR_INF)
        assert ref[1].stop_reason[5].item() == stops[5].item()
        assert bool(torch.all(torch.cat([stops[:5], stops[6:]]) > 0))
        log(f"[K2] SE3 nan neighbour {dtype}: instance 5 stops "
            f"{stops[5].item()}, its neighbours {stops[:8].tolist()}, max "
            f"|x_k - x_twin| = {err:.3e}")

    mark("k2_se3")

    # ---- 4c. K2's multi-color branch (Curtis-Powell-Reid probes, 2 colors)
    # on the hard suite's coupled problems, Powell singular and Wood:
    # 10,000 perturbed standard starts, max_iters=200, no failure budget,
    # float32 and float64, LM and the dogleg; each held against the twin
    # bit for bit, and K2 with coloring "auto" against K2 with "off" (a jvp
    # a dimension) bit for bit; timed both ways; B = 1, 3, 257 and a NaN
    # start beside the others ----
    def mc_options(solver_type, coloring="auto", iters=200):
        return to.Options(
            max_iters=iters, max_consec_failures=0, solver_type=solver_type,
            hessian=to.HessianOptions(solver="fused", save_last=False,
                                      carry_system=False,
                                      diag_coloring=coloring))

    mc_fns = {"powell": powell_singular_residuals, "wood": wood_residuals}

    def mc_starts(name, B, dtype, nan_at=None):
        x0 = (torch.tensor(MC_STARTS[name], dtype=dtype, device=dev)
              + 0.1 * torch.randn((B, 4), generator=gen, dtype=dtype,
                                  device=dev))
        if nan_at is not None:
            x0[nan_at] = float("nan")
        return x0

    def mc_kernel(name, opts, x0):
        """K2 on ``x0`` with a plan, parameters and color tables built
        once, as ``fused_batched_solver`` builds them."""
        fn = mc_fns[name]
        plan = cuda_solver.fused_plan(opts, "residuals", x0[0],
                                      residual_fn=fn)
        assert plan is not None, f"{name} outside the fused envelope"
        assert (plan.coloring is None) == (
            opts.hessian.diag_coloring == "off"), name
        params = cuda_solver.k2_params(cuda_solver.FAMILIES[fn].id, opts,
                                       plan)
        tables = (None if plan.coloring is None else
                  cuda_solver.color_tables(plan.coloring, x0.dtype, dev))
        kern = lambda: cuda_solver.fused_solve(  # noqa: E731
            fn, opts, x0, None, plan, params, tables)
        plain = lambda: cuda_solver.fused_solve_plain(  # noqa: E731
            fn, opts, x0, None, plan)
        kp = cuda_solver.k2_launch_plan(
            x0.shape[0], 4, plan.n_res, x0.element_size(),
            cuda_solver.FAMILIES[fn].id,
            cuda_solver.coloring_kind(plan.coloring), params.solver)
        lanes = (f"{32 // kp.S} instances a warp, one a thread" if kp.S == 1
                 else f"{kp.S} threads an instance")
        return kern, plain, (f"path {kp.path}, {lanes} (S={kp.S}, E={kp.E}),"
                             f" blocks of {kp.warps * 32} threads, grid "
                             f"<= {kp.grid}")

    # The twin's host loop takes ~0.1 s an iteration of the dogleg, so it
    # is held to the kernel over the first MC_HOLD_ITERS iterations (timed
    # there, both sides, as the *_hold_ms and *_plain_ms keys); the kernel's
    # full-depth call is held to the one with the coloring off and, in
    # phase 5b, to the path's
    mc_runs = {}       # each cell's starts and full-depth result, for 5b
    for dtype in (torch.float32, torch.float64):
        tag = "" if dtype == torch.float32 else "_f64"
        for name in ("powell", "wood"):
            for sname, st in (("", to.LevenbergMarquardt),
                              ("_dl", to.DogLeg)):
                x0 = mc_starts(name, BATCH, dtype)
                key = f"mc_{name}{sname}"
                kern, _, kplan = mc_kernel(name, mc_options(st), x0)
                got = kern()
                hkern, hplain, _ = mc_kernel(
                    name, mc_options(st, iters=MC_HOLD_ITERS), x0)
                hgot = hkern()
                ref, k2[f"{key}_plain_ms{tag}"] = timed(hplain)
                what = f"K2 multi-color {name}{sname} {dtype}"
                k2[f"{key}_max_abs_err{tag}"] = mc_check(ref, hgot, what)
                mc_runs[key + tag] = (x0, got)
                kern_off, _, kplan_off = mc_kernel(name, mc_options(st, "off"),
                                                   x0)
                off = kern_off()
                mc_check(off, got, what + " auto vs off")
                k2[f"{key}_ms{tag}"] = gpu_ms(kern, n=3)
                k2[f"{key}_off_ms{tag}"] = gpu_ms(kern_off, n=3)
                k2[f"{key}_hold_ms{tag}"] = gpu_ms(hkern, n=3)
                (k2[f"{key}_hold_bound_ms{tag}"],
                 k2[f"{key}_hold_bound_by{tag}"]) = mc_bound(
                    hgot[1], name, x0.element_size(), bool(sname))
                out = got[1]
                (k2[f"{key}_bound_ms{tag}"],
                 k2[f"{key}_bound_by{tag}"]) = mc_bound(
                    out, name, x0.element_size(), bool(sname))
                k2[f"{key}_share{tag}"] = (k2[f"{key}_bound_ms{tag}"]
                                           / k2[f"{key}_ms{tag}"])
                k2[f"{key}_mean_iters{tag}"] = (
                    out.num_iters.float().mean().item())
                stops = torch.bincount(out.stop_reason.clamp(min=0)).tolist()
                assert bool(torch.all(out.succeeded())), what
                log(f"[K2] multi-color {name}{sname} {BATCH}x4 {dtype} "
                    f"({kplan}; off: {kplan_off}): bit-equal to the twin "
                    f"over {MC_HOLD_ITERS} iterations (kernel "
                    f"{k2[f'{key}_hold_ms{tag}']:.4f} ms, twin "
                    f"{k2[f'{key}_plain_ms{tag}']:.1f} ms) and to coloring "
                    f"off; iterations mean "
                    f"{k2[f'{key}_mean_iters{tag}']:.2f} max "
                    f"{out.num_iters.max().item()}, stops {stops}; kernel "
                    f"{k2[f'{key}_ms{tag}']:.4f} ms, off "
                    f"{k2[f'{key}_off_ms{tag}']:.4f} ms; bound "
                    f"{k2[f'{key}_bound_ms{tag}']:.5f} ms "
                    f"({k2[f'{key}_bound_by{tag}']}), share "
                    f"{k2[f'{key}_share{tag}']:.4f}")
    mark("k2_multicolor_cells")
    # small batches and a NaN start beside its warp's other instances (at
    # 16, the middle of a warp of 32 one-lane instances, and at 5), at
    # MC_EDGE_ITERS iterations (the twin's host loop costs ~0.1 s an
    # iteration of the dogleg, whatever the batch)
    for B, name, st, dtype, nan_at in (
            (1, "powell", to.LevenbergMarquardt, torch.float32, None),
            (3, "wood", to.DogLeg, torch.float64, None),
            (257, "powell", to.DogLeg, torch.float32, None),
            (257, "wood", to.LevenbergMarquardt, torch.float64, None),
            (64, "wood", to.LevenbergMarquardt, torch.float32, 5),
            (64, "powell", to.DogLeg, torch.float64, 5),
            (33, "wood", to.DogLeg, torch.float32, 16),
            (257, "powell", to.LevenbergMarquardt, torch.float64, 16)):
        x0 = mc_starts(name, B, dtype, nan_at)
        kern, plain, kplan = mc_kernel(
            name, mc_options(st, iters=MC_EDGE_ITERS), x0)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        what = f"K2 multi-color {name} {st.name} {B}x4 {dtype}"
        mc_check(ref, got, what)
        stops = got[1].stop_reason
        if nan_at is not None:
            assert stops[nan_at].item() == int(
                to.StopReason.SYSTEM_HAS_NAN_OR_INF), what
            assert bool(torch.all(torch.cat([stops[:nan_at],
                                             stops[nan_at + 1:]]) > 0)), what
        log(f"[K2] {what[3:]} ({kplan})"
            f"{f' NaN at {nan_at}' if nan_at is not None else ''}: "
            f"bit-equal to the twin, stops {stops[:8].tolist()}")

    mark("k2_multicolor")

    # ---- 5. the paths: the main path (LM, fused and cg), then the dogleg
    # through both and the fused LM with the history; the launch counts are
    # set to 0 just before each path and read just after ----
    data, x0 = make_prior_batch(BATCH, DIMS, torch.float32, generator=gen,
                                device=dev)
    paths = {
        "fused": (bench_options(to), "K2"),
        "cg": (bench_options(to, "cg"), "K1"),
        "dogleg_fused": (bench_options(to, solver_type=to.DogLeg), "K2"),
        "dogleg_cg": (bench_options(to, "cg", solver_type=to.DogLeg), "K1"),
        "history_fused": (bench_options(to, save_history=True), "K2"),
    }
    path_launches = PathLaunches(cuda_solver)
    for name, (opts, kernel) in paths.items():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        x, out = to.batched_optimize(x0, prior_residual, opts,
                                     data_batch=data)
        torch.cuda.synchronize()
        n = path_launches[name] = {"K1": cuda_cg.cg_solve.launches,
                                   "K2": cuda_solver.fused_solve.launches}
        log(f"[main] {name}: launches {n}")
        assert n[kernel] > 0, f"the {name} path did not launch {kernel}"
        assert x.shape == (BATCH, DIMS) and torch.all(torch.isfinite(x))
        assert torch.all(out.succeeded()), name
        # the prior's optimum is x = y
        gap = (x - data.y).abs().max().item()
        assert gap < 1e-4, f"{name}: max|x - y| = {gap}"
        if opts.save_history:
            assert out.errs.shape == (BATCH, opts.max_iters + 1), name
            assert torch.equal(out.num_hist, out.num_iters), name
        log(f"[main] {name}: max|x - y| = {gap:.3e}, conv "
            f"{out.converged().float().mean().item():.4f}")
    launches = path_launches["fused"] | {"K1": path_launches["cg"]["K1"]}

    record["main"] = {}
    for name, (opts, _) in paths.items():
        solve = to.batched_solver(prior_residual, opts, "residuals", x0[0],
                                  type(data)(*(a[0] for a in data)))
        solve(x0, data)                        # warm-up call, untimed
        times, conv, iters = [], [], []
        for rep in range(REPS):
            g = torch.Generator(device=dev).manual_seed(1000 + rep)
            d_rep, x_rep = make_prior_batch(BATCH, DIMS, torch.float32,
                                            generator=g, device=dev)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _, out = solve(x_rep, d_rep)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            conv.append(out.converged().float().mean().item())
            iters.append(out.num_iters.float().mean().item())
        rec = {"ms": times, "median_ms": statistics.median(times),
               "solves_per_s": REPS * BATCH / (sum(times) / 1e3),
               "conv": sum(conv) / REPS, "mean_iters": sum(iters) / REPS}
        record["main"][name] = rec
        log(f"[main] {name}: {rec['solves_per_s']:.1f} solves/s "
            f"({REPS} reps x {BATCH} over {sum(times):.3f} ms; median rep "
            f"{rec['median_ms']:.3f} ms), conv {rec['conv']:.4f}, mean iters "
            f"{rec['mean_iters']:.3f}, ms {times}")

    mark("paths")

    # ---- 5b. the multi-color paths: batched_optimize on Powell singular
    # and Wood (solver="fused", the hard suite's 2-color coloring) on phase
    # 4c's 10,000 starts, float32 and float64, LM and the dogleg — one K2
    # launch and no K1 each, the launch counts set to 0 just before and
    # read just after, held bit for bit against phase 4c's full-depth
    # kernel call (itself held to the twin); then solves/s of a
    # batched_solver built once, over REPS calls on fresh starts (host work
    # included) ----
    record["mc_paths"] = {}
    for key, (x0, ref) in mc_runs.items():
        name = key.split("_")[1]
        st = to.DogLeg if "_dl" in key else to.LevenbergMarquardt
        opts = mc_options(st)
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        cuda_solver.fused_solve.lane_launches = 0
        got = to.batched_optimize(x0, mc_fns[name], opts)
        torch.cuda.synchronize()
        n = path_launches[key] = {
            "K1": cuda_cg.cg_solve.launches,
            "K2": cuda_solver.fused_solve.launches,
            "K2 one lane": cuda_solver.fused_solve.lane_launches}
        # one K2 launch, of the one-lane instance, and no K1
        assert n == {"K1": 0, "K2": 1, "K2 one lane": 1}, \
            f"{key}: launches {n}"
        mc_check(ref, got, f"{key} through batched_optimize")
        assert bool(torch.all(got[1].succeeded())), key
        solve = to.batched_solver(mc_fns[name], opts, "residuals", x0[0])
        solve(x0)                              # warm-up call, untimed
        times = []
        for rep in range(REPS):
            x_rep = mc_starts(name, BATCH, x0.dtype)
            _, ms = timed(lambda: solve(x_rep))
            times.append(ms)
        sps = REPS * BATCH / (sum(times) / 1e3)
        base = key.replace("_f64", "")
        k2[f"{base}_path_solves_per_s{key[len(base):]}"] = sps
        record["mc_paths"][key] = {"launches": n, "ms": times,
                                   "solves_per_s": sps}
        log(f"[main] {key}: launches {n}, bit-equal to the twin; {sps:.1f} "
            f"solves/s ({REPS} reps x {BATCH}, ms {times})")

    mark("multicolor_paths")

    # ---- 6. the flagship path: batched SE(3) pose refinement (models/
    # se3_refinement, 10k instances of 16 points, float32) with bench_se3's
    # options through "fused" (K2's SE3 family), "cg" (the loop and K1) and
    # "cholesky" (the loop, no kernel of the TPU's); the launch counts set
    # to 0 just before each path and read just after ----
    sdata, sx0, strue = make_se3_refinement(BATCH, SE3_K, dtype=torch.float32,
                                            seed=3, device=dev)
    se3_paths = {"se3_fused": (se3_options(to), "K2"),
                 "se3_cg": (se3_options(to, "cg"), "K1"),
                 "se3_cholesky": (se3_options(to, "cholesky"), None)}
    # each instance's least cost, from float64 solves of the same values
    # (cholesky, up to 30 iterations).  A float32 path stops within its
    # costs' rounding of it: 5.4e-5 relative at most on this data, 5.3e-5
    # for the JAX package's own loop on its float32 data (PERF.md, PR 6),
    # so the limit is 1e-4.  At that floor the step proposed from a
    # rejected point is rounding, and an instance whose three proposals in
    # a row stay above min_step_norm2 stops by its failure budget
    # (MAX_CONSEC_NO_DECR, a success) instead of MIN_DELTA_NORM, as the
    # JAX package's loop does (2 of 340,000 instance-solves there, 7 for
    # the port, never the same instance); so conv is printed, and every
    # instance must succeed and reach the least cost
    x64, out64 = to.batched_optimize(
        pytree.tree_map(lambda a: a.double(), sx0), se3_residual,
        se3_options(to, "cholesky", max_iters=30),
        data_batch=type(sdata)(*(a.double() for a in sdata)))
    assert torch.all(out64.converged()), "float64 flagship reference"
    cost64 = out64.final_cost.cost
    rot64, trans64 = pose_errors(to, x64, pytree.tree_map(
        lambda a: a.double(), strue))
    log(f"[flagship] float64 minimum: largest error against the true poses: "
        f"rotation {rot64:.3e} rad, translation {trans64:.3e}")
    record["flagship_f64"] = {"max_rot_err": rot64, "max_trans_err": trans64}
    record["flagship"] = {}
    for name, (opts, kernel) in se3_paths.items():
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        cuda_solver.fused_solve.se3_launches = 0
        x, out = to.batched_optimize(sx0, se3_residual, opts,
                                     data_batch=sdata)
        torch.cuda.synchronize()
        n = path_launches[name] = {
            "K1": cuda_cg.cg_solve.launches,
            "K2": cuda_solver.fused_solve.launches,
            "K2 SE3": cuda_solver.fused_solve.se3_launches}
        log(f"[flagship] {name}: launches {n}")
        if kernel == "K2":
            # one K2 launch, of the SE3 family's register kernel
            assert n == {"K1": 0, "K2": 1, "K2 SE3": 1}, \
                f"{name}: launches {n}"
        elif kernel == "K1":
            assert n["K1"] > 0 and n["K2"] == 0, f"{name}: launches {n}"
        else:
            assert n == {"K1": 0, "K2": 0, "K2 SE3": 0}, \
                f"{name}: launches {n}"
        assert x.rotation.wxyz.shape == (BATCH, 4), name
        assert x.translation.shape == (BATCH, 3), name
        assert bool(torch.all(torch.isfinite(x.rotation.wxyz))), name
        assert bool(torch.all(torch.isfinite(x.translation))), name
        assert torch.all(out.succeeded()), name
        conv = out.converged().float().mean().item()
        stops = torch.bincount(out.stop_reason.clamp(min=0)).tolist()
        gap = ((out.final_cost.cost.double() - cost64) / cost64).max().item()
        assert gap < 1e-4, f"{name}: cost {gap} above the float64 minimum"
        rot, trans = pose_errors(to, x, strue)
        # the targets carry noise of std 1e-3: each path's poses lay within
        # 1.73e-3 rad and 1.36e-3 of the true ones on this data (PERF.md,
        # PR 6), as the float64 minimum's do
        assert rot < 2.5e-3 and trans < 2.5e-3, \
            f"{name}: errors {rot}, {trans}"
        record["flagship"][name] = {
            "conv": conv, "mean_iters": out.num_iters.float().mean().item(),
            "stops": stops, "max_cost_gap_to_f64": gap,
            "max_rot_err": rot, "max_trans_err": trans}
        log(f"[flagship] {name}: conv {conv:.4f} (stops {stops}), mean iters "
            f"{out.num_iters.float().mean().item():.3f}, largest cost above "
            f"the float64 minimum {gap:.3e} (relative), largest error "
            f"against the true poses: rotation {rot:.3e} rad, translation "
            f"{trans:.3e}")
    for name, (opts, _) in se3_paths.items():
        solve = to.batched_solver(se3_residual, opts, "residuals",
                                  pytree.tree_map(lambda a: a[0], sx0),
                                  type(sdata)(*(a[0] for a in sdata)))
        solve(sx0, sdata)                      # warm-up call, untimed
        times, conv, iters = [], [], []
        for rep in range(REPS):
            d_rep, x_rep, _ = make_se3_refinement(
                BATCH, SE3_K, dtype=torch.float32, seed=1000 + rep,
                device=dev)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _, out = solve(x_rep, d_rep)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            conv.append(out.converged().float().mean().item())
            iters.append(out.num_iters.float().mean().item())
        rec = {"ms": times, "median_ms": statistics.median(times),
               "solves_per_s": REPS * BATCH / (sum(times) / 1e3),
               "conv": sum(conv) / REPS, "mean_iters": sum(iters) / REPS}
        record["flagship"][name].update(rec)
        log(f"[flagship] {name}: {rec['solves_per_s']:.1f} solves/s "
            f"({REPS} reps x {BATCH} over {sum(times):.3f} ms; median rep "
            f"{rec['median_ms']:.3f} ms), conv {rec['conv']:.4f}, mean iters "
            f"{rec['mean_iters']:.3f}, ms {times}")

    mark("flagship")

    # ---- 7. robust curve fits (examples/robust_curve_fit.py's model:
    # y = a exp(b t), 60 points a curve, 25 % gross outliers), 10,000
    # curves made on the card, float32, through the "cg" solver: the loop
    # with K1 at d = 2 (no K2 family exists for these residuals) — least
    # squares, Huber- and Geman-McClure-whitened residuals (the latter
    # from the Huber fit, as the example starts it), and the Huber fit by
    # finite differences (mode="numdiff"); the launch counts set to 0 just
    # before each path and read just after ----
    CurveData = curve_fit.CurveData

    curve_paths = {
        "curve_ls_cg": (curve_fit.exp_residuals, "auto", None),
        "curve_huber_cg": (curve_fit.huber_residuals, "auto", None),
        "curve_gm_cg": (curve_fit.geman_mcclure_residuals, "auto",
                        "curve_huber_cg"),
        "curve_huber_numdiff_cg": (curve_fit.huber_residuals, "numdiff",
                                   None),
    }
    cdata, cx0 = curve_fit.make_curve_batch(BATCH, seed=5, device=dev)
    c64 = CurveData(*(a.double() for a in cdata))
    true_ab = torch.tensor(curve_fit.TRUE_AB, device=dev)
    record["curves"], fits, fits64 = {}, {}, {}
    for name, (fn, mode, start) in curve_paths.items():
        x_start = cx0 if start is None else fits[start][0]
        x_start64 = cx0.double() if start is None else fits64[start]
        cuda_cg.cg_solve.launches = 0
        cuda_solver.fused_solve.launches = 0
        cuda_solver.fused_solve.warp_launches = 0
        x, out = to.batched_optimize(x_start, fn, curve_options(to),
                                     data_batch=cdata, mode=mode)
        torch.cuda.synchronize()
        n = path_launches[name] = {"K1": cuda_cg.cg_solve.launches,
                                   "K2": cuda_solver.fused_solve.launches}
        log(f"[curves] {name}: launches {n}")
        assert n["K1"] > 0 and n["K2"] == 0, f"{name}: launches {n}"
        assert out.num_diff_used == (mode == "numdiff"), name
        fits[name] = (x, out)
        # the float64 least cost of each curve: the same function from the
        # same start, float64, through "cholesky"
        x64, out64 = to.batched_optimize(
            x_start64, fn, curve_options(to, "cholesky"), data_batch=c64,
            mode="residuals" if mode == "auto" else mode)
        fits64[name] = x64
        CURVE_F64[name] = out64.final_cost.cost
        if name == "curve_huber_cg":
            CURVE_F64["x_huber"] = x64
        assert x.shape == (BATCH, 2) and bool(torch.all(torch.isfinite(x)))
        assert bool(torch.all(out.succeeded())), name
        assert bool(torch.all(out64.succeeded())), name + " float64"
        # limit 1e-5: float32 costs of 60 residuals round to ~1e-7 of the
        # float64 least cost (3e-7 at most in a CPU rehearsal of 300 curves)
        gap = ((out.final_cost.cost.double() - out64.final_cost.cost)
               / out64.final_cost.cost).abs().max().item()
        assert gap < 1e-5, f"{name}: cost {gap} from the float64 solve"
        err = (x - true_ab).abs().sum(dim=-1)
        stops = torch.bincount(out.stop_reason.clamp(min=0)).tolist()
        record["curves"][name] = {
            "conv": out.converged().float().mean().item(),
            "mean_iters": out.num_iters.float().mean().item(),
            "max_iters": out.num_iters.max().item(), "stops": stops,
            "max_cost_gap_to_f64": gap,
            "median_ab_err": err.median().item()}
        log(f"[curves] {name}: conv {record['curves'][name]['conv']:.4f} "
            f"(stops {stops}), iterations mean "
            f"{record['curves'][name]['mean_iters']:.2f} max "
            f"{record['curves'][name]['max_iters']}, largest cost gap to "
            f"the float64 solve {gap:.3e} (relative), median "
            f"|a - 1.7| + |b - 0.8| {err.median().item():.4f}")
    # the robust fits recover (1.7, 0.8) better than least squares on most
    # curves (limit 0.9; all 300 in the CPU rehearsal)
    err_ls = (fits["curve_ls_cg"][0] - true_ab).abs().sum(dim=-1)
    for name in ("curve_huber_cg", "curve_gm_cg"):
        share = ((fits[name][0] - true_ab).abs().sum(dim=-1)
                 < err_ls).float().mean().item()
        record["curves"][name]["share_better_than_ls"] = share
        log(f"[curves] {name}: nearer (1.7, 0.8) than least squares on "
            f"{share:.4f} of the curves")
        assert share > 0.9, f"{name}: better than least squares on {share}"
    # numdiff against automatic differentiation, limit 2e-3: float32
    # central differences at h = 1e-4 carry eps / h ~ 1e-3 relative
    # rounding in J (7.3e-4 in the CPU rehearsal)
    nd_gap = (fits["curve_huber_numdiff_cg"][0]
              - fits["curve_huber_cg"][0]).abs().max().item()
    record["curves"]["numdiff_vs_ad_max_abs"] = nd_gap
    log(f"[curves] Huber by numdiff against automatic differentiation: "
        f"max |x_nd - x_ad| = {nd_gap:.3e}")
    assert nd_gap < 2e-3, f"numdiff x {nd_gap} from automatic differentiation"
    for name, (fn, mode, start) in curve_paths.items():
        solve = to.batched_solver(fn, curve_options(to), mode, cx0[0],
                                  CurveData(cdata.t[0], cdata.y[0]))
        times = []
        for rep in range(2):
            d_rep, x_rep = curve_fit.make_curve_batch(BATCH, seed=2000 + rep,
                                                      device=dev)
            if start is not None:      # the Huber fit of this rep's curves
                x_rep, _ = to.batched_optimize(
                    x_rep, curve_fit.huber_residuals, curve_options(to),
                    data_batch=d_rep)
            (_, out), ms = timed(lambda: solve(x_rep, d_rep))
            times.append(ms)
        rec = record["curves"][name]
        rec.update(ms=times, solves_per_s=2 * BATCH / (sum(times) / 1e3))
        log(f"[curves] {name}: {rec['solves_per_s']:.1f} solves/s (2 reps x "
            f"{BATCH}, ms {times})")

    mark("curves")
    for phase in (phase8, phase9, phase10, phase11, phase12, phase13,
                  phase14, phase15, phase16, phase17, phase18, phase19,
                  phase20, phase21, phase22, phase23):
        phase(to, dev, record, path_launches, cuda_cg, cuda_solver)
        mark(phase.__name__)
    log(f"[time] seconds: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in part_s.items())}, total "
        f"{time.perf_counter() - t_main:.1f}")
    # K2's warp kernel (solver_kernel, max(d, n_res) > 64) on each path
    warp = record["k2_warp_path_launches"] = {
        p: n["K2 warp"] for p, n in path_launches.items()}
    log(f"[K2] warp kernel launches on each path: {warp}")

    ba_k1 = record["ba"]["k1"]
    kernels = [
        {"name": "K1 cg_warp_kernel", "route": "cuda",
         "source": "tinyopt_tpu_torch/csrc/cg.cu",
         "replaces": "tinyopt_tpu/ops/pallas_cg.py:77",
         "launches": launches["K1"],
         "path_launches": {p: n["K1"] for p, n in path_launches.items()},
         "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms_torch.float32"],
         "plain_ms": k1["plain_ms_torch.float32"],
         "bound_ms": k1["bound_ms_torch.float32"],
         "bound_by": k1["bound_by_torch.float32"],
         "share": k1["share_torch.float32"],
         "library_ms": None, "ms_f64": k1["ms_torch.float64"],
         "bound_ms_f64": k1["bound_ms_torch.float64"],
         "share_f64": k1["share_torch.float64"],
         "d6_ms": k1["d6_ms"], "d6_ms_f64": k1["d6_ms_f64"],
         "d6_plain_ms": k1["d6_plain_ms"], "d6_bound_ms": k1["d6_bound_ms"],
         "d6_bound_by": k1["d6_bound_by"], "d6_share": k1["d6_share"],
         "d6_share_f64": k1["d6_share_f64"],
         "d2_ms": k1["d2_ms"], "d2_ms_f64": k1["d2_ms_f64"],
         "d2_plain_ms": k1["d2_plain_ms"], "d2_bound_ms": k1["d2_bound_ms"],
         "d2_bound_by": k1["d2_bound_by"], "d2_share": k1["d2_share"],
         "d2_share_f64": k1["d2_share_f64"],
         "curve_launches": {p: n["K1"] for p, n in path_launches.items()
                            if p.startswith("curve_")},
         **{f"icp_{k}": v for k, v in record["icp"]["k1"].items()}},
        # the block kernel (d > 64) on the batched BA's "cg" path, phase
        # 16c, at (1000, 96, 96), 96 iterations: "registers" in float32,
        # "split" in float64; d = 65, 100, 300 and 2100 (the wide kernel) from phase 3
        {"name": "K1 cg_block_kernel", "route": "cuda",
         "source": "tinyopt_tpu_torch/csrc/cg.cu",
         "replaces": "tinyopt_tpu/ops/pallas_cg.py:77",
         "launches": ba_k1["launches"],
         "path_launches": {p: n["K1"] for p, n in path_launches.items()
                           if p.startswith("ba_")},
         "max_abs_err": ba_k1["max_abs_err"], "ms": ba_k1["ms"],
         "plain_ms": ba_k1["plain_ms"], "bound_ms": ba_k1["bound_ms"],
         "bound_by": ba_k1["bound_by"], "share": ba_k1["share"],
         "library_ms": None,
         **{k: v for k, v in ba_k1.items()
            if k not in ("launches", "max_abs_err", "ms", "plain_ms",
                         "bound_ms", "bound_by", "share")},
         **{k: v for k, v in k1.items() if k.startswith("blk_")}},
        {"name": "K2 solver_seg_kernel", "route": "cuda",
         "source": "tinyopt_tpu_torch/csrc/solver_seg.cuh",
         "replaces": "tinyopt_tpu/ops/pallas_solver.py:150",
         "launches": launches["K2"],
         "path_launches": {p: n["K2"] for p, n in path_launches.items()},
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms_torch.float32"],
         "plain_ms": k2["plain_ms_torch.float32"],
         "bound_ms": k2["bound_ms_torch.float32"], "bound_by": "bytes",
         "share": k2["share_torch.float32"],
         "library_ms": None, "ms_f64": k2["ms_torch.float64"],
         "bound_ms_f64": k2["bound_ms_torch.float64"],
         "share_f64": k2["share_torch.float64"],
         "js_ms": k2["js_ms_torch.float32"],
         "js_ms_f64": k2["js_ms_torch.float64"],
         **{f"{w}js_{k}{t}": k2[f"{w}js_{k}_torch.float{b}"]
            for w in ("", "dl_") for k in ("bound_ms", "bound_by", "share")
            for t, b in (("", 32), ("_f64", 64))},
         "dl_ms": k2["dl_ms_torch.float32"],
         "dl_ms_f64": k2["dl_ms_torch.float64"],
         "dl_plain_ms": k2["dl_plain_ms_torch.float32"],
         "dl_share": k2["dl_share_torch.float32"],
         "dl_share_f64": k2["dl_share_torch.float64"],
         "dl_max_abs_err": k2["dl_max_abs_err_torch.float32"],
         "dl_js_ms": k2["dl_js_ms_torch.float32"],
         "dl_js_ms_f64": k2["dl_js_ms_torch.float64"],
         "hist_ms": k2["hist_ms_torch.float32"],
         "hist_ms_f64": k2["hist_ms_torch.float64"],
         "hist_plain_ms": k2["hist_plain_ms_torch.float32"],
         "hist_bound_ms": k2["hist_bound_ms_torch.float32"],
         "hist_bound_ms_f64": k2["hist_bound_ms_torch.float64"],
         "hist_share": k2["hist_share_torch.float32"],
         "hist_share_f64": k2["hist_share_torch.float64"]},
        # the SE3 family's register kernel (K <= 21 points): phase 6's
        # flagship path (launches) and phase 4b's times at 10k x 16; the
        # headline numbers are LM float32, every cell as se3_*
        {"name": "K2 solver_se3_kernel (SE3 family)", "route": "cuda",
         "source": "tinyopt_tpu_torch/csrc/solver_se3.cuh",
         "replaces": "tinyopt_tpu/ops/pallas_solver.py:150",
         "launches": path_launches["se3_fused"]["K2 SE3"],
         "path_launches": {p: n["K2 SE3"] for p, n in path_launches.items()
                           if "K2 SE3" in n},
         "max_abs_err": k2["se3_max_abs_err"], "ms": k2["se3_ms"],
         "plain_ms": k2["se3_plain_ms"], "bound_ms": k2["se3_bound_ms"],
         "bound_by": k2["se3_bound_by"], "share": k2["se3_share"],
         "library_ms": None,
         **{k: v for k, v in k2.items() if k.startswith("se3_")}},
        # the one-lane instance (S = 1, one instance a thread) on Powell's
        # and Wood's families, the multi-color branch: phase 5b's paths
        # (launches) and phase 4c's times; the headline numbers are Powell
        # DogLeg 10k x 4 float32, every cell as mc_*
        {"name": "K2 solver_seg_kernel, one instance a lane (S = 1)",
         "route": "cuda",
         "source": "tinyopt_tpu_torch/csrc/solver_seg.cuh",
         "replaces": "tinyopt_tpu/ops/pallas_solver.py:150",
         "launches": path_launches["mc_powell_dl"]["K2 one lane"],
         "path_launches": {p: n["K2 one lane"]
                           for p, n in path_launches.items()
                           if "K2 one lane" in n},
         "max_abs_err": max(v for k, v in k2.items()
                            if k.startswith("mc_") and "max_abs_err" in k),
         # the kernel and the twin at the twin's depth (MC_HOLD_ITERS);
         # the full-depth call (200 iterations) as mc_powell_dl_ms...
         "ms": k2["mc_powell_dl_hold_ms"],
         "plain_ms": k2["mc_powell_dl_plain_ms"],
         "bound_ms": k2["mc_powell_dl_hold_bound_ms"],
         "bound_by": k2["mc_powell_dl_hold_bound_by"],
         "share": (k2["mc_powell_dl_hold_bound_ms"]
                   / k2["mc_powell_dl_hold_ms"]),
         "hold_iters": MC_HOLD_ITERS, "library_ms": None,
         **{k: v for k, v in k2.items() if k.startswith("mc_")}},
        # the generated families (ops/residual_codegen.py) in the same
        # kernel, one instance a thread, each built into a library of its
        # own: phase 21's paths (launches) and times; the headline numbers
        # are the Huber curve fit, 10k x 60 float32, every cell as gen_*
        {"name": "K2 generated (solver_seg_kernel on a family generated "
                 "from the traced residual)", "route": "cuda",
         "source": "tinyopt_tpu_torch/csrc/solver_gen.cuh",
         "replaces": "tinyopt_tpu/ops/pallas_solver.py:150",
         "launches": path_launches["curve_huber_fused"]["K2 generated"],
         "path_launches": {p: n["K2 generated"]
                           for p, n in path_launches.items()
                           if "K2 generated" in n},
         "max_abs_err": record["gen"]["max_abs_err"],
         "ms": record["gen"]["curves"]["huber"]["ms"],
         "plain_ms": record["gen"]["curves"]["huber"]["plain_ms"],
         "bound_ms": record["gen"]["curves"]["huber"]["bound_ms"],
         "bound_by": record["gen"]["curves"]["huber"]["bound_by"],
         "share": record["gen"]["curves"]["huber"]["share"],
         "library_ms": None, "ptxas": record["gen"]["ptxas"],
         "build_s": record["gen"]["build_s"],
         **{f"gen_curve_{k}_{f}": v[f]
            for k, v in record["gen"]["curves"].items()
            for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share",
                      "max_abs_err", "bit_equal")},
         **{f"gen_curve_{k}_{side}_solves_per_s": v[side]["solves_per_s"]
            for k, v in record["gen"]["turns"].items()
            for side in ("fused", "cg")},
         **{f"gen_{k}_{f}": v[f] for k, v in record["gen"]["suite"].items()
            for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share",
                      "max_abs_err", "bit_equal")}},
        # the generated families on manifold parameters (the retraction
        # traced into the family), the same kernel: phase 22's paths
        # (launches) and times; the headline numbers are the robust
        # point-to-point SE3 fit, 10k x 16 float32, every cell as gen_mf_*
        {"name": "K2 generated on manifold parameters (solver_seg_kernel "
                 "on a family traced through the retraction)",
         "route": "cuda",
         "source": "tinyopt_tpu_torch/csrc/solver_seg.cuh",
         "replaces": "tinyopt_tpu/ops/pallas_solver.py:150",
         "launches": path_launches["mf_icp_huber"]["K2 generated"],
         "path_launches": {p: n["K2 generated"]
                           for p, n in path_launches.items()
                           if p.startswith("mf_")},
         "max_abs_err": record["mf"]["max_abs_err"],
         "ms": record["mf"]["cells"]["icp_huber"]["ms"],
         "plain_ms": record["mf"]["cells"]["icp_huber"]["plain_ms"],
         "bound_ms": record["mf"]["cells"]["icp_huber"]["bound_ms"],
         "bound_by": record["mf"]["cells"]["icp_huber"]["bound_by"],
         "share": record["mf"]["cells"]["icp_huber"]["share"],
         "library_ms": None, "build_s": record["mf"]["build_s"],
         **{f"gen_mf_{k}_{f}": v[f]
            for k, v in record["mf"]["cells"].items()
            for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share",
                      "emitter_bound_ms", "max_abs_err", "bit_equal",
                      "ptxas")},
         **{f"gen_mf_{k}_{side}_solves_per_s": v[side]["solves_per_s"]
            for k, v in record["mf"]["turns"].items()
            for side in ("fused", "cg")},
         "gen_mf_icp_plain_vs_hand_ms": record["mf"]["icp_plain_vs_hand"][
             "ms"]},
        # the generated families past max(P, D, n_res) = 64 in K2's warp
        # kernel (the warp form, and the multi-color branch): phase 23's
        # paths (launches) and times; the headline numbers are the robust
        # point-to-point SE3 fit, 4,096 pairs x 128 points float32, every
        # cell as wide_*
        {"name": "K2 generated, warp kernel (solver_kernel on a family "
                 "generated from the traced residual, past 64)",
         "route": "cuda",
         "source": "tinyopt_tpu_torch/csrc/solver_warp.cuh",
         "replaces": "tinyopt_tpu/ops/pallas_solver.py:150",
         "launches": path_launches["wide_icp_huber"]["K2 warp"],
         "path_launches": {p: n["K2 warp"] for p, n in path_launches.items()
                           if p.startswith("wide_")},
         "max_abs_err": record["wide"]["max_abs_err"],
         **{f: record["wide"]["cells"]["icp_huber"][f]
            for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share")},
         "library_ms": None, "ptxas": record["wide"]["ptxas"],
         "build_s": record["wide"]["build_s"],
         **{f"wide_{k}_{f}": v[f]
            for k, v in record["wide"]["cells"].items()
            for f in ("ms", "ms_hold", "plain_ms", "bound_ms", "bound_by",
                      "share", "max_abs_err", "bit_equal", "runs_equal",
                      "launches", "ptxas")},
         **{f"wide_{k}_{side}_solves_per_s": v[side]["solves_per_s"]
            for k, v in record["wide"]["turns"].items()
            for side in ("fused", "cg")},
         "wide_icp_plain_vs_hand_ms": record["wide"]["icp_plain_vs_hand"][
             "ms"]},
    ]
    record.update(k1=k1, k2=k2, kernels=kernels)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
