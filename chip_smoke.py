"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py               # all phases, one card
    python3 chip_smoke.py --phases 3    # phases 1-2, then only the listed ones

Phases, each of which raises (exit code != 0) when it fails:
  1. the card: nvidia-smi name and power limit, TF32 switched off;
  2. the kernel build (one nvcc per CUDA source, in parallel);
  3. every kernel against its plain PyTorch version on the card, in
     float64 and float32: at the free-time shapes (demo9 N = 10, B = 256,
     R = 1 and 2) and at the fix-time shapes of the production step
     (goldens/bench_fix_fixture.npz tiled to 256 rows x 5 candidates =
     1280 lanes, fix_terminal and fix_free_end, R = 2), kkt_qr at the fix
     shapes; at the rollout's shapes (R = 2): the sweep's free rung (step
     0, 1024 worlds x 2 candidates = 2048 lanes, N = 6) and demo8's N = 15
     replans (K = 60, np = 79, QR saddle order ~720) in all three
     variants, from its goldens' 30 closed-loop states; at the fix step's
     width in the two remaining variants (R = 2, VARIANT_STAGES): the
     fixture's 256 rows x 5 candidates in fix_eq_band (1280 lanes) and as
     free-time problems with coupled motion x 2 candidates (512 lanes;
     S = 4 spine slots a block, kkt_qr too), every kernel timed there in
     float32 as at the fix_terminal shape; at the open
     loop's shapes (R = 2): demo9's free-time N = 74 problem (5 candidate
     lanes, np = 374: spd_inv_blocked, the AL solve's global route, the
     line search's spread route) and its fix_terminal
     problem at N = 50 (2 lanes; no kkt_qr: the open loop has no QR
     rung); spd_inv alone at m = 8, 16, 17, 33, 54, 79, 120 (4096
     matrices each: both routes of csrc/spd_inv.cu, whose route
     kernels.spd_inv_route must equal the library's at m = 1-120) and at
     m = 124, 204, 254 and 374 (spd_inv_blocked) on seeded SPD,
     near-singular and non-SPD matrices; times (CUDA
     events) of the kernel, its plain version and, for spd_inv,
     spd_inv_blocked and kkt_qr, the PyTorch library call for the same
     function (for newton_assemble the library time of its dominant
     products, baddbmm(Hpp, (JD_sp sigma)^T, JD_sp) and bmm(JE_sp^T,
     JE_sp)), at the free-time, the fix_terminal and the N = 74 float32
     shapes (N = 74 also in float64); newton_assemble also W-only (the QR
     rung's call), and it, the provider, spd_inv, spd_inv_blocked,
     newton_schur, newton_al_solve, step_linesearch and kkt_qr also as
     device time inside a CUDA graph (graph_ms); newton_al_solve at every
     shape also with its route (kernels.al_solve_route, which must equal
     the library's) and a NaN planted in one (lane, rung)'s Sinv and
     another lane's Qinv (good False there alone, as the plain version),
     timed also at the sweep's float32 shape; step_linesearch at every
     shape on both routes of kernels.ls_route (which must equal the
     library's): the main path's route on every lane, clean and with four
     planted lanes (a NaN in the picked rung, no good rung, every trial
     rejected, a_s = 0: no step on either side), and the other route on
     a slice or a tiling of the lanes, planted; each call's CUDA graph
     replay bit-equal to the eager call; timed also at the sweep's float32
     shape, with the trials its inputs need and the trials it evaluates
     (the bound counts the needed ones); obca_kkt_provider at every shape
     with its launch plan (kernels.provider_launch_plan, the library's)
     and a graph replay bit-equal to the eager call, timed (graph_ms,
     CTAs a lane; the bound counts inputs and outputs) at the
     fix, free, sweep and N = 74 (both dtypes) shapes and at the host
     driver's 2 and 5 lanes at N = 6 and N = 15; spd_inv_blocked also
     split by sub-kernel (panel, syrk, trtri, lauum: device ms per
     launch from a profiler window, per call at the launches of
     kernels.spdb_launch_plan); kkt_qr also at a sweep rescue rung's
     batch (the first 16 fix_terminal lanes x R = 2 = 32 matrices, both
     dtypes, held to the same checks; timed in float32), with a profile
     of its kernels there and at 2560 matrices; newton_schur at every
     shape with its launch plan (kernels.schur_launch_plan, the
     library's), a graph replay bit-equal to the eager call and the
     SHA-1s of Yq and S (to hold two checkouts' kernels to the same bits),
     timed (graph_ms, tiles a lane, bound) at the fix, free, sweep, N = 74
     (both dtypes) and host driver (2 and 5 lanes at N = 6 and 15)
     shapes; ipm_freeze against the plain freeze (solver/loop.py), bit for
     bit with its flags, the body's pass-through fields aliased as the
     loop passes them, at the fix step's 1280 lanes, the host runner's 5
     (fix time) and 2 (free time) lanes and the N = 74 open loop's 5 in
     both dtypes, with its copy plan, the SHA-1s of its outputs and the
     device work of a graphed replay (the freeze kernel, no memset),
     timed at the runner's, the fix step's and the N = 74 float32 shapes
     (as the loop runs it and with every field copied); kkt_qr_dense on
     the sweep batch's saddle matrices (qr.saddle_matrix) against its
     plain version and kkt_qr's assembled route, timed in float32;
  4. the entry problem (demo1, N = 6, IPMOptions(max_iters=60)) through
     the kernels in float64 and float32; float64 must match the plain
     version run on the CPU (same iters, z within 1e-6);
  5. the free-time slice at full size: demo9_window_batch(256) with
     BENCH_FREE_OPTIONS in float32, through the kernels and through the
     plain versions on the card: feasible fraction, iterations,
     lane-iterations, solves/s (median of 3 timed reps after a warm-up);
  6. the production fix-time step: make_fix_step(qr_rescue=True) on
     fix_fixture_batch(256) in float32 (mpc6 -> mpc8 -> QR rescue, 1280
     solver lanes per rung), through the kernels (5 timed reps after a
     warm-up) and once through the plain versions: ladder feasible
     fraction (>= 0.99), the rows each rung made feasible, iterations per
     rung, steps/s, launches per kernel;
  7. the QR rescue rung on its own: the kkt="qr" fix_terminal multistart,
     no skip, on the first 32 fixture rows (160 lanes) in float32 through
     the kernels (kkt_qr must launch); then rows 0 and 1 in float64 on the
     card against the same solve run plain on the CPU (same iters, z
     within 1e-6);
  8. the random sweep at full width: sweep_inputs(1024, seed=0) in float32
     (1024 demo1-family worlds, reference paths from the wavefront A*
     kernels), then make_scan_rollout(max_steps=30, qr_rescue=True)
     through the kernels: failed_frac <= 0.03 and mean_progress_frac >=
     0.17 (the JAX package's float32 run of the same worlds:
     SWEEP_r04.json, 0.0104 and 0.1966); replans, wall seconds, replans/s,
     the rungs' world-steps and host-loop iterations per step, launches.
     Then 64 worlds x 3 steps through the kernels and through the plain
     versions, both feasible on every step;
  9. the 11 demos, 30 steps each in float32 through the kernels: no abort,
     end distance at most the golden's + 0.2 d0 (test_demos_e2e.py); demo1
     and demo3 also in float64: mode flags equal to goldens/demo*.npz and
     states within 1e-6 at every step;
 10. the open loop (runtime/open_loop.py, bench.py's open-loop entries):
     (a) bench.py's openloop_N74_s problem (demo9, free time, N = 74, 5
     candidates) in float32 through the kernels: one warm call, then 3
     calls with bench's 1e-6 candidate perturbation, the minimum as
     openloop_N74_s, iterations, feasibility (required), and a
     torch.profiler window of 10 iterations; (b) the same problem in
     float64 through the kernels and through the plain versions on the
     card: the same picked candidate and iterations and z within 1e-6, or
     else the first iteration where they split and the condition number
     of S there, both feasible and objectives within 1e-6 relative; (c)
     run_open_loop("demo9", N=50) and (d) run_open_loop("demo1", N=50,
     fix_phase=False) in float64, held to tests/test_open_loop.py's
     properties (dynamics defect <= 1e-4 free and 1e-3 fix, start within
     1e-6, goal within 2e-2, no ego corner inside a static obstacle, the
     terminal set, no fallback on demo9); (e) bench.py's horizon table at
     N = 6, 10, 20, 40, 74 in float32 (s_per_solve: the minimum of 2
     perturbed calls; N >= 10 must be feasible); (f)
     Simulation().calc_time("demo9", N=10) in float64, feasible;
 11. the host closed-loop driver (runtime/closed_loop.py, main.py's
     default mode): (a) the 11 demos, 30 steps, float32, through the
     graphed Newton loop and the kernels: no abort, end distance at most
     the golden's + 0.2 d0; replan_ms p50/p99 (all steps and per branch),
     iterations, fix-time steps, fallbacks and QR rescues from the
     runner's MetricsLogger; (b) demo1 and demo3 in float64: mode and
     fallback flags equal to the goldens, states within 1e-6 at every
     step; (c) demo3 in float64 and float32 through the graphed loop and
     the host loop, both with the kernels: per-step iterations equal and
     states bit-equal; (d) run_legacy("mpc1") and ("mpc3") on demo1, 3
     steps, float32 (tests/test_closed_loop.py's properties); (e) a
     torch.profiler window over demo3's first fix-time replan (k = 3, its
     winning start as all 5 candidates) with the host loop and with the
     graph: device idle share, the host's CUDA launches and its
     synchronisations (stream, event and device) per replan and per
     iteration; (a) also reports the graphs built and their build and
     instantiate milliseconds;
 12. the two remaining OBCA variants at the fix step's width
     (entry.eq_band_fixture_batch and entry.coupled_fixture_batch, 256
     fixture rows: 1280 and 512 lanes) as multistarts through
     make_obca_solver's graphed loop and the kernels (every kernel of the
     fused body must launch): float32 rows/s (median of 3 after a counted
     warm-up), the slowest lane's iterations and the feasible fraction,
     at most 0.02 below the plain host loop's on the card; float64
     against the plain host loop: feasibility and iterations equal on
     >= 99% of rows each, the picked z within 1e-6 on every row of equal
     iterations;
 13. the runtime modules: (1) the free batch (demo9, N = 10, B = 256,
     BENCH_FREE_OPTIONS) in float32 and float64 solved monolithically and
     by solver/compact.py's solve_compacted with bench.py's parameters
     (chunk 24, buckets 256 -> 64) and the JAX package's defaults (chunk
     16, down to 16 lanes: step_linesearch's spread route): every lane's
     iterations, feas, converged and result bits equal to the monolithic
     solve's; lane_iters, dispatched_lane_iters against B x the slowest
     lane, each bucket's routes and graph captures, solves/s of the three
     forms (median of 7), a chunk boundary's and a 64-lane gather's cost
     (CUDA events); (2) phase 8's sweep (or the same sweep run here) as
     15 steps, its LoopState through utils/checkpoint.py's
     SweepCheckpointer, then 15 steps more from the loaded state: every
     field of the state and the trajectory bit-equal to the 30-step run;
     (3) the native A* (native/, built with g++) on every demo: a search's
     cells equal to the batch entry's over 8 starts, its cost the Python
     search's, host ms of both;
 14. the AD solver (solver/ad.py build_solver): (a) the tiny NLP of the
     JAX package's tests/test_solver.py:32 in float64, converged and
     within 1e-5 of scipy's SLSQP; (b) kkt="arrow" (HVP probes with the
     grouped spine coloring) on the free batch (demo9, N = 10, B = 256,
     BENCH_FREE_OPTIONS) in float32 and float64 through the graphed loop
     with the kernels and through the plain host loop: spd_inv and
     ipm_freeze launched, no kernel in the plain run, feasible fraction
     >= 0.99 on both, float64 iterations equal on every lane and z within
     1e-9 max-normalised (|dz|_max / |z|_max, phase 3's measure); solves/s
     and the slowest lane beside the fused solve on the same batch, and in
     float64 the lanes within one iteration of it and the largest z gap
     on lanes feasible in both; (c) al_chol, chol, the dense qr
     (build_obca_ad_solver) and arrow without Hessian coloring on its
     first 16 lanes in float64, kernels through the graphed loop against
     plain through the host loop (iterations equal, z within 1e-9
     max-normalised, ipm_freeze launched, every family on the graph),
     al_chol against arrow (iterations equal, z within 1e-6), chol's
     feasibility reported (chol capped at 25 iterations: it fails on
     these lanes and would run to 100); (d) kkt_qr_dense on the qr family's first
     saddle matrices (16 of order 690) against its plain version, timed
     against its bound and linalg.qr + solve_triangular; (e) a
     device_trace around one arrow solve holding its annotate range and
     spd_inv's kernel events; sharded_batch_solver over make_mesh()
     bit-equal to the unsharded solve;
 15. the device loop (kernels/csrc/device_loop.cu: each solve one CUDA
     graph, its Newton iterations under a conditional WHILE node): the
     free batch (float32 B = 256, float64 B = 64), the fix step's four
     rungs (256 x 5, float32), a QR rung (32 x 5, float64), the N = 74
     open loop (float64) and the AD arrow family (float64 B = 64), each
     bit-equal to loop="host" on every output, host seconds of both
     (median of 3 after the first call, which builds the graph),
     iterations, graph launches a call, graphs built and their build and
     instantiate ms; the fix step's mpc6 under
     torch.cuda.set_sync_debug_mode("error") from its graph launch to its
     result read (no host synchronisation). The kernels line's
     device_loop row: the free batch's solve graphed against loop="host"
     (CUDA events around a call), its bound the loop's own 8 bytes an
     iteration.
Phases 5, 6, 8, 10, 12, 13 and 14 run the device loop too (the default on
the card); phase 8 also reports its graphs, their build ms and peak device
memory.
Then one JSON line of every kernel (launches on its main path: the
sweep's, phase 8, for spd_inv_blocked the open loop's, phase 10, and for
ipm_freeze and device_loop the host driver's, phase 11, every phase's under
"launches_by_phase"; errors, times, bound; for the five fused-body
kernel its errors and times at the float32 variant stages under
"variants"; for
newton_assemble also its N = 74 float32 times under "N74", for kkt_qr
its sweep-batch times under "sweep_batch" and its dense entry
(kkt_qr_dense: the sweep batch and phase 14's qr rung, with its launches
by phase) under "dense", for newton_al_solve, spd_inv
and step_linesearch their routes and times at every main path's shape
under "shapes", for obca_kkt_provider its CTAs a lane and times there,
for newton_schur its tiles and times there, for ipm_freeze its times and
bounds at 5, 1280 and N = 74's 5 lanes, for device_loop phase 15's solves
under "solves" and its graphs under "graphs"),
the nvidia-smi line and the device line.

Tolerances (phase 3), max-normalised errors |k - p|_max / |p|_max over
the finite entries; non-finite entries must sit where the plain version
has them:
  * float64: <= 1e-9 on every output of the provider, the three Newton
    stages, the line search and kkt_qr (only the summation order, or the
    factorization, differs);
  * float32: <= 1e-3 on the provider, the Newton assembly and Schur
    stages and the line search. newton_al_solve and kkt_qr instead hold
    the saddle-system residual ||K sol - rhs||_inf / ||rhs||_inf
    (evaluated in float64) of every (lane, rung) the curvature test
    accepts to at most 3x the plain version's residual of the same
    (lane, rung), + 1e3 eps, because the kernels factor differently
    (direct Cholesky against the JAX package's block-Schur recursion;
    hand-written Householder QR against the library's) and float32
    rounding of an ill-conditioned saddle system moves the solution, not
    the residual. The AL solve's residual is not zero even in exact
    arithmetic (a fixed number of refinement steps): its limit is 3x the
    larger of the plain version's and the same algorithm's run in float64
    on the same inputs;
  * newton_al_solve and kkt_qr, both dtypes: the rung flags `good` agree
    (kkt_qr also with a NaN planted in W);
  * spd_inv and spd_inv_blocked, both dtypes: the backward error
    ||A X - I|| / (||A|| ||X||) <= 1e3 eps, and NaN over the whole
    matrix (the non-SPD signal) where the plain version has it, except on
    a matrix whose smallest eigenvalue lies within SPD_BORDER * m * eps
    ||A|| of zero, where either answer is rounding;
  * astar_cost_to_go and astar_extract_path, both dtypes, at the sweep's
    1024 maps (11 x 40; also at caps of 0, 1 and 7 relaxations, and its
    first 2 maps), the demo9 (61 x 41) and demo10 (11 x 100) grids,
    demo9's tiled over 1024 maps, an all-free 11 x 40 grid and a 21 x 21
    serpentine maze (440 and 441 maps, and 8 and 4): the field and the
    relaxation counts equal bit for bit, the path and valid mask equal
    (the same additions and exact minima); the warp route and the CTA
    route of astar_cost_to_go each run (kernels.astar_route, which must
    equal the library's);
  * ipm_freeze, both dtypes: the state, the next active flags and the
    loop flag equal bit for bit (a masked copy and integer tests).

Bounds: the least time the card could take for a kernel's work, the
larger of bytes / 3.35 TB/s (each input read once, each output written
once) and the operations counted from the kernel's loops (dominant terms;
for the line search, the trials these inputs need) over the card's peak
outside the tensor cores (67 TFLOP/s float32, 34
TFLOP/s float64; NVIDIA's H100 SXM data sheet, at a 700 W power limit).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch"
JAX_PKG = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu"
REPLACES = {
    "obca_kkt_provider": f"{JAX_PKG}/models/obca_struct.py:292",
    "spd_inv": f"{JAX_PKG}/solver/ipm.py:317",
    "spd_inv_blocked": f"{JAX_PKG}/solver/ipm.py:352",
    "newton_assemble": f"{JAX_PKG}/solver/ipm.py:882",
    "newton_schur": f"{JAX_PKG}/solver/ipm.py:937",
    "newton_al_solve": f"{JAX_PKG}/solver/ipm.py:957",
    "step_linesearch": f"{JAX_PKG}/solver/ipm.py:1126",
    "kkt_qr": f"{JAX_PKG}/solver/ipm.py:1341",
    "astar_cost_to_go": f"{JAX_PKG}/ops/astar.py:45",
    "astar_extract_path": f"{JAX_PKG}/ops/astar.py:92",
    "ipm_freeze": f"{JAX_PKG}/solver/ipm.py:1369",
    "device_loop": f"{JAX_PKG}/solver/ipm.py:1380",
}
ASTAR = ("astar_cost_to_go", "astar_extract_path")
TIME_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores (TF32 would not hold phase 3's
# tolerances); float64 through the tensor cores (DMMA), the card's fastest
# float64 rate: the bound is the least time the card could take
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
# Width, in units of m * eps ||A||, of the band around a zero smallest
# eigenvalue where the direct Cholesky and the block-Schur recursion may
# disagree on whether an (m, m) matrix is SPD. Set from the readings of
# phase 3: the 22 of 2560 float32 m = 33 matrices where they disagree lie
# within 0.30 m eps ||A|| (PERF.md, PR 3). Higham's sufficient condition
# for Cholesky to succeed, lambda_min > 20 m^1.5 u ||A||_2 (u = eps / 2),
# is wider.
SPD_BORDER = 1.0
FUSED = ("obca_kkt_provider", "spd_inv", "newton_assemble", "newton_schur",
         "newton_al_solve", "step_linesearch")
# the phase whose run is a kernel's main path (the kernels line's launches)
MAIN_PHASE = {"spd_inv_blocked": 10, "ipm_freeze": 11, "device_loop": 11}
# total planned time of demo9's float64 open loop at N = 10 (Ts_opt
# 12.934 s x 10 steps, the CPU run of tests/test_torch_openloop.py): the
# time scale of the fix-time shapes checked in phase 3
DEMO9_OPEN_TOTAL_S = 129.34


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def no_jax(where):
    check("jax" not in sys.modules, f"jax was imported ({where})")


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=20, warm=3):
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, n=20, reps=10):
    """Device milliseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events (what a call
    costs inside the graphed Newton loop, without its host-side wrapper)."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    gc_on = gc.isenabled()
    gc.disable()   # a collection could destroy another graph mid-capture
    try:
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
    finally:
        if gc_on:
            gc.enable()
    return time_ms(g.replay, reps=reps, warm=1) / n


def max_err(k, p):
    """(max abs error, max-normalised error) over finite entries; NaN
    patterns must agree."""
    import torch

    fk, fp = torch.isfinite(k), torch.isfinite(p)
    check(bool((fk == fp).all()), "non-finite entries differ from the plain version")
    if not bool(fp.any()):
        return 0.0, 0.0
    d = (k - p)[fp].abs().max().item()
    scale = p[fp].abs().max().item()
    return d, d / max(scale, 1e-300)


def inv_backward_error(A, X):
    """Per-matrix ||A X - I||_inf / (||A||_inf ||X||_inf), worst finite."""
    import torch

    A64, X64 = A.double(), X.double()
    m = A.shape[-1]
    eye = torch.eye(m, dtype=torch.float64, device=A.device)
    R = A64 @ X64 - eye
    nrm = lambda M: M.abs().sum(-1).amax(-1)
    eta = nrm(R) / (nrm(A64) * nrm(X64))
    fin = torch.isfinite(X64).all(-1).all(-1)
    return eta[fin].max().item() if bool(fin.any()) else 0.0


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def sha1(t):
    """SHA-1 of a tensor's bytes: two checkouts' outputs compared bit for bit."""
    import hashlib

    return hashlib.sha1(t.detach().contiguous().view(-1).cpu().numpy().tobytes()).hexdigest()


def bound(bytes_moved, flops, dtype):
    """(bound_ms, bound_by) of work moving ``bytes_moved`` and doing
    ``flops`` operations in ``dtype`` on an H100 SXM."""
    t_b = bytes_moved / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# ------------------------------------------------------------------ phases

def phase_card():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
            f"nvidia-smi unavailable: {smi.stderr.strip()}")
    log(line)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"[card] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return line


def phase_build():
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import build

    t0 = time.time()
    info = build.build_all()
    log(f"[build] {time.time() - t0:.1f} s wall (nvcc in parallel)")
    for name in build.SOURCES:
        log(f"[build] {name}: {info[name]['path']}")
        for line in info[name]["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    for name in build.SOURCES:
        build.load(name)


def _rollout_problem(source, variant, dtype, dev, B=1024):
    """(spec, data, opt, candidates) of a rollout rung at the shapes the
    main path gives it, under the rollout's options: ``source`` "sweep" is
    step 0 of the sweep (B worlds x the 2 free-time candidates; N = 6, nO
    = 4); "demo8" (N = 15, K = 60, np = 79) the replans at the 30
    closed-loop states of goldens/demo8.npz, its dynamic obstacles moved
    by the recorded step durations and sensed, with the rung's candidates
    per state (2 free, 5 fix)."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        sweep_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        OBCASpec, build_obca_data)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        astar_host)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
        candidate_inits_traced, dodge_boxes)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.reference import (
        reinterpolate_openloop, window_reference)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
        N_CAND_FREE, SCAN_OPTIONS)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario, get_demo)

    if source == "sweep":
        scn, shape, p, ref, ref_len = sweep_inputs(B, seed=0, dtype=dtype, device=dev)
        x0 = scn.start
        u0 = torch.zeros((B, 2), dtype=dtype, device=dev)
        Ts = torch.full((B,), p.Ts, dtype=dtype, device=dev)
    else:
        demo = get_demo(source)
        p = demo.params
        scn, shape = build_scenario(demo, dtype=dtype, device=dev)
        check(bool((scn.d_start_time == 0).all()), f"{source}: obstacles start late")
        g = np.load(os.path.join(HERE, "goldens", f"{source}.npz"))
        path = astar_host.reference_path_for(scn.grid.cpu().numpy(), demo.start, demo.goal)
        ref = torch.as_tensor(path, device=dev).to(dtype)
        ref_len = path.shape[1]
        t = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        # the state, input and step duration before each recorded step
        x0 = torch.cat([scn.start[None], t(g["x"][:-1])])
        u0 = torch.cat([torch.zeros((1, 2), dtype=dtype, device=dev), t(g["u"][:-1])])
        Ts = torch.cat([t([p.Ts]), t(g["ts"][:-1])])
        moved = torch.cat([t([0.0]), t(np.cumsum(g["ts"])[:-1])])
        B = x0.shape[0]
    N = p.N_free
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant=variant)
    weights = dict(v_max=p.v_max, w_max=p.w_max, a_max=p.a_max,
                   alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)
    xref = window_reference(ref, ref_len, x0, N)
    if variant == "free":
        data = build_obca_data(spec, scn, x0=x0, u0=u0, xref=xref, Ts=Ts, q=p.q_free,
                               r1=p.r1_free, r2=p.r2_free, time_c1=p.time_c1,
                               time_c2=p.time_c2, **weights)
        return spec, data, SCAN_OPTIONS, candidate_inits_traced(xref, x0)[:, :N_CAND_FREE]
    xref, _ = reinterpolate_openloop(xref, N, N)
    ts_idx = torch.where(scn.ts_rel < 0, 3, scn.ts_rel).long().reshape(4)
    x0_ext = torch.cat([x0, torch.zeros((B, 1), dtype=dtype, device=dev)], 1)
    delta = moved[:, None, None] * scn.d_vel
    sensed = torch.ones((B, scn.d_vel.shape[0]), dtype=torch.bool, device=dev)
    data = build_obca_data(
        spec, scn, x0=x0, u0=u0, xref=xref, Ts=Ts, dyn_active=sensed.to(dtype),
        dyn_delta=delta, Ts_pred=Ts,
        terminal_set=scn.ts_base + x0_ext[:, ts_idx].reshape(B, 2, 2),
        q=p.q_fix, r1=p.r1_fix, r2=p.r2_fix, **weights)
    boxes = dodge_boxes(scn.dyn_info, scn.dyn_info[:, :2] + delta, scn.d_vel, Ts, sensed, N)
    y_bounds = (scn.x_lo[1].expand(B), scn.x_hi[1].expand(B))
    return spec, data, SCAN_OPTIONS, candidate_inits_traced(xref, x0, dyn_boxes=boxes,
                                                            y_bounds=y_bounds)


def _openloop_problem(variant, N, dtype, dev):
    """(spec, data, opt, candidates) of demo9's open loop at horizon N:
    the free-time problem of bench.py's horizon table (its N = 74 entry
    under OPENLOOP_N74_OPTIONS), or the fix-time problem of phase 2, its
    plan the dilated A* start timed at DEMO9_OPEN_TOTAL_S (the shapes and
    a realistic iterate, not phase 1's solution)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        horizon_inputs, openloop_n74_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.open_loop import (
        OPEN_OPTIONS, _resampled_astar_init, fix_time_problem)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario, get_demo)

    if variant == "free":
        spec, data, cands, opt = (openloop_n74_inputs if N == 74 else
                                  lambda d, v: horizon_inputs(N, d, v))(dtype, dev)
        return spec, data, opt, cands
    demo = get_demo("demo9")
    scn, shape = build_scenario(demo, dtype=dtype, device=dev)
    plan = _resampled_astar_init(scn, demo, N, dtype, dilation=2, align_start=True)
    spec, data, cands, _ = fix_time_problem(demo, scn, shape, plan, N, N,
                                            DEMO9_OPEN_TOTAL_S / N, demo.params, dtype,
                                            variant=variant)
    return spec, data, OPEN_OPTIONS, cands


def _stage_inputs(kind, dtype, dev, R):
    """Every kernel's inputs at a realistic interior iterate, after 3 plain
    iterations: ``kind`` "free" is the demo9 B = 256 batch; "fix_terminal"
    and "fix_free_end" are the fixture's 256 rows x 5 candidates; "band
    fix_eq_band" the same rows and candidates in fix_eq_band (1280 lanes)
    and "coupled free" the same rows as free-time problems with coupled
    motion, x 2 candidates (512 lanes; ``VARIANT_BATCHES``); "sweep free"
    and "demo8 <variant>" are the rollout's (``_rollout_problem``);
    "open<N> <variant>" the open loop's (``_openloop_problem``)."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, FIX6_OPTIONS, FIX8_OPTIONS, demo9_window_batch,
        fix_fixture_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    cands = None
    if kind == "free":
        spec, data, _, _ = demo9_window_batch(256, dtype=dtype, device=dev)
        opt = BENCH_FREE_OPTIONS
    elif kind in ("fix_terminal", "fix_free_end"):
        spec6, spec8, data, cands = fix_fixture_batch(256, dtype=dtype, device=dev)
        spec, opt = (spec6, FIX6_OPTIONS) if kind == "fix_terminal" else (spec8, FIX8_OPTIONS)
    elif kind in VARIANT_STAGES:
        spec, data, cands, opt, _ = _variant_batch(VARIANT_STAGES[kind], dtype, dev)
    elif kind.startswith("open"):
        source, variant = kind.split()
        spec, data, opt, cands = _openloop_problem(variant, int(source[4:]), dtype, dev)
    else:
        spec, data, opt, cands = _rollout_problem(*kind.split(), dtype, dev)
    z0 = None
    if cands is not None:
        nC = cands.shape[1]
        data = type(data)(*[f.repeat_interleave(nC, dim=0) for f in data])
        z0 = init_vars(spec, data, x_init=cands.reshape((-1,) + cands.shape[2:]))
    solve = make_obca_solver(spec, opt, impl="plain")
    st = solve.iterate(solve.init(data, z0), data, 3)
    return _stage_from(kind, spec, data, opt, solve, st, R)


# the fix_eq_band and coupled-motion batches at the fix step's width (entry
# builders of the same names), each stage of phase 3 by its batch
VARIANT_BATCHES = ("band", "coupled")
VARIANT_STAGES = {"band fix_eq_band": "band", "coupled free": "coupled"}


def _variant_batch(name, dtype, dev, B=256):
    """(spec, data, candidates, options, candidates a row) of the variant
    batch ``name``, B fixture rows: "band" under the fix step's mpc6
    options (5 candidates), "coupled" under the rollout free rung's, whose
    2 candidates it takes."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        FIX6_OPTIONS, coupled_fixture_batch, eq_band_fixture_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
        SCAN_OPTIONS)

    if name == "band":
        return (*eq_band_fixture_batch(B, dtype=dtype, device=dev), FIX6_OPTIONS, 5)
    return (*coupled_fixture_batch(B, dtype=dtype, device=dev), SCAN_OPTIONS, 2)


def _stage_from(kind, spec, data, opt, solve, st, R):
    """Every kernel's inputs at the iterate ``st`` of ``solve`` (plain),
    the plain versions' outputs beside them (see ``_stage_inputs``)."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import obca
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
        newton_al_solve_plain, newton_assemble_plain, newton_schur_plain)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
        _spd_inv)

    dev, dtype = st.zv.device, st.zv.dtype
    L = solve.layout
    ops = L.ops(dev, dtype)
    sgn_raw, id_off = obca.ineq_identity_sgn_off(spec, data)
    sgn_eff = sgn_raw * ops.ds[ops.id_idx]
    m_id = L.m_id
    w_d = st.w[:, m_id:].contiguous()
    bnd = solve.provider.plain(st.zv, data, st.sf, st.scE, st.scD, st.y, w_d)
    cI = torch.cat([sgn_eff * st.zv[:, ops.id_idx] + id_off, bnd.cD], 1)
    jeTp, jeTq = ops.f_jeT(bnd, st.y)
    jiTp, jiTq = ops.f_jiT(bnd, st.w, sgn_eff)
    r_d = bnd.g - ops.f_flat(jeTp + jiTp, jeTq + jiTq)
    sigma = st.w / st.s
    up, uq = ops.f_jiT(bnd, (st.w * cI - st.mu_b[:, None]) / st.s, sgn_eff)
    rhs1 = (-r_d - ops.f_flat(up, uq)).contiguous()
    rhs2 = (-bnd.cE).contiguous()
    base = torch.clamp(st.delta, min=opt.delta0)
    ladder = (base[:, None] * (opt.delta_step ** torch.arange(
        R, dtype=dtype, device=dev))).contiguous()
    dd = opt.delta_d_al
    c = lambda ts: tuple(t.contiguous() for t in ts)
    asm = c(newton_assemble_plain(ops, bnd, sigma, sgn_eff, ladder, dd))
    Qinv = _spd_inv(asm[5]).contiguous()
    Yq, Smat = c(newton_schur_plain(ops, Qinv, asm[4], asm[3], ladder))
    Sinv = _spd_inv(Smat).contiguous()
    sols, goods = c(newton_al_solve_plain(ops, bnd, *asm[:3], asm[4], Qinv, Yq,
                                          Sinv, rhs1, rhs2, ladder, dd,
                                          opt.delta_d, opt.n_refine))
    return dict(kind=kind, spec=spec, data=data,
                data_flat=kernels.pack_obca_data(data), opt=opt, solve=solve,
                st=st, L=L, ops=ops, sgn_eff=sgn_eff, id_off=id_off, w_d=w_d,
                bnd=bnd, cI=cI, sigma=sigma, rhs1=rhs1, rhs2=rhs2,
                ladder=ladder, dd=dd, asm=asm, Qinv=Qinv, Yq=Yq, Smat=Smat,
                Sinv=Sinv, sols=sols, goods=goods)


def _saddle_residual(x, sol, delta):
    """(B,) ||K sol - rhs||_inf / ||rhs||_inf of every lane for the
    delta_d-regularized saddle system of one rung."""
    import torch

    ops, bnd, opt = x["ops"], x["bnd"], x["opt"]
    Wpp, Wpq, Wqq = x["asm"][:3]
    n = x["L"].n
    dz, v = sol[:, :n], sol[:, n:]
    dp, dq = ops.split(dz)
    op = (torch.einsum("bpc,bc->bp", Wpp, dp)
          + ops.slot_add(ops.red(torch.einsum("bksc,bkc->bks", Wpq, dq))))
    oq = (torch.einsum("bksc,bsk->bkc", Wpq, ops.slots_of(dp))
          + torch.einsum("bkcd,bkd->bkc", Wqq, dq))
    vp, vq = ops.f_jeT(bnd, v)
    r1 = ops.f_flat(op + delta[:, None] * dp + vp,
                    oq + delta[:, None, None] * dq + vq) - x["rhs1"]
    r2 = ops.f_jev(bnd, dp, dq) - opt.delta_d * v - x["rhs2"]
    res = torch.maximum(r1.abs().amax(1), r2.abs().amax(1))
    scale = torch.maximum(x["rhs1"].abs().amax(1), x["rhs2"].abs().amax(1))
    return res / scale


def _float64(x):
    """The saddle systems of ``x`` upcast to float64: the same numbers,
    for residuals free of float32 evaluation rounding."""
    import torch

    d = torch.float64
    y = dict(x, ops=x["L"].ops(x["rhs1"].device, d),
             bnd=type(x["bnd"])(*[t.to(d) for t in x["bnd"]]),
             asm=tuple(t.to(d) for t in x["asm"]))
    for k in ("rhs1", "rhs2", "ladder", "Qinv", "Yq", "Sinv"):
        y[k] = x[k].to(d)
    return y


def check_saddle_solve(name, tag, x64, ksol, kgood, psol, pgood, exact=None):
    """newton_al_solve and kkt_qr against their plain versions (see the
    tolerances above); ``exact`` is the same algorithm run in float64 on
    the same inputs, where its own residual is not zero (the AL solve's
    fixed number of refinement steps). Returns the row of the report."""
    import torch

    dtype = ksol.dtype
    eps = torch.finfo(dtype).eps
    check(bool((kgood == pgood).all()),
          f"{name} {tag}: good differs on {int((kgood != pgood).sum())} rungs")
    a, r = max_err(ksol, psol)
    if dtype == torch.float64:
        check(r <= 1e-9, f"{name} {tag}: rel {r:.3e} > 1e-09")
    res = []
    for j in range(kgood.shape[1]):
        g = kgood[:, j]
        if not bool(g.any()):
            res.append({"good": 0})
            continue
        dl = x64["ladder"][:, j]
        rk = _saddle_residual(x64, ksol[:, j].double(), dl)[g]
        rp = _saddle_residual(x64, psol[:, j].double(), dl)[g]
        ref = rp
        row = {"good": int(g.sum()), "max": rk.max().item(), "max_plain": rp.max().item()}
        if exact is not None:
            re = _saddle_residual(x64, exact[:, j], dl)[g]
            # a NaN reference would make the limit NaN and pass any
            # residual: there the plain version's residual alone sets it
            nan = re.isnan()
            ref = torch.where(nan, rp, torch.maximum(rp, re))
            row["max_float64"] = re.max().item()
            row["float64_nan"] = int(nan.sum())
            # lanes the float64 run's residual lets through
            row["above_3x_plain"] = int((rk > 3.0 * rp + 1e3 * eps).sum())
        lim = 3.0 * ref + 1e3 * eps
        row["ratio_to_limit"] = (rk / lim).max().item()
        if dtype == torch.float32:
            bad = ~(rk <= lim)   # a NaN residual or limit fails too
            i = int(torch.argmax((rk / lim).nan_to_num(float("inf"))))
            check(not bool(bad.any()),
                  f"{name} {tag} rung {j}: residual above its limit on {int(bad.sum())} "
                  f"of {int(g.sum())} accepted lanes (worst: {rk[i].item():.3e}, plain "
                  f"{rp[i].item():.3e}, limit {lim[i].item():.3e})")
        res.append(row)
    return {"abs": a, "rel": r, "residual": res, "good": int(kgood.sum())}


def _flops(name, L, B, R, opt, m=None, count=None):
    """Operations of one call, counted from the kernel's loops (dominant
    terms; multiply and add count as two)."""
    np_, K, bq, S, n, mE = L.np_, L.K, L.bq, L.S, L.n, L.mE
    mE_sp, mD_sp, mI = L.mE_sp, L.mD_sp, L.mI
    if name == "obca_kkt_provider":   # the spine blocks' nonzeros (the row plan's), not their zeros
        from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
            spine_row_plan)
        out = (n + mE + L.mD + spine_row_plan(L.spec).nnz
               + K * (2 + 4 * bq + 2 * S + S * bq + bq * bq))
        return B * (4 * out + 30 * (n + mE + L.mD))
    if name in SPD:
        return count * m ** 3
    if name == "newton_assemble":   # the symmetric spine products: upper triangle
        return B * (np_ * (np_ + 1) * (mD_sp + mE_sp) + 8 * K * bq * bq
                    + 8 * K * S * bq + R * K * bq * bq)
    if name == "newton_schur":
        return B * R * (2 * K * bq * S * (bq + S) + np_ * np_)
    if name == "newton_al_solve":
        G = 2 * (K * bq * bq + 2 * K * S * bq + np_ * np_)
        jv = 2 * (mE_sp * np_ + 2 * K * (1 + bq))
        wmv = 2 * (np_ * np_ + 2 * K * S * bq + K * bq * bq)
        nr = opt.n_refine
        return B * R * (jv + G + jv + nr * (wmv + 4 * jv + G) + wmv)
    if name == "step_linesearch":   # count: the trials these inputs need (_ls_trials)
        return count * (10 * (mE + mI) + 4 * n) + B * (2 * mD_sp * np_ + 8 * mI)
    if name == "kkt_qr":
        M = n + mE
        return B * R * (4 * M ** 3 // 3 + 8 * M * M + 2 * n * n)
    raise KeyError(name)


SPD = ("spd_inv", "spd_inv_blocked")


def check_spd(A, tag, planted, timing):
    """kernels.spd_inv on A (..., m, m) against the plain version (see the
    tolerances above); ``planted`` are flat indices of matrices that must
    come out NaN. Returns (the kernel that served it, the report row)."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
        _spd_inv)

    m = A.shape[-1]
    name = SPD[m > kernels.SPD_INV_MAX_M]
    eps = torch.finfo(A.dtype).eps
    flat = A.reshape(-1, m, m)
    nm = flat.shape[0]
    before = kernels.launches[name]
    Xk = kernels.spd_inv(A)
    check(kernels.launches[name] == before + 1, f"{name} {tag}: not launched")
    Xp = _spd_inv(A)
    fin_k = torch.isfinite(Xk).reshape(nm, -1)
    fin_p = torch.isfinite(Xp).reshape(nm, -1)
    nan_k, nan_p = ~fin_k.all(1), ~fin_p.all(1)
    # both kernels' non-SPD flag NaNs the whole matrix
    check(bool((fin_k.any(1) == ~nan_k).all()), f"{name} {tag}: a partly non-finite inverse")
    # the two factorizations may only disagree on a matrix whose smallest
    # eigenvalue lies within rounding of zero
    differ = nan_k != nan_p
    lmin = 0.0     # worst |lambda_min| / ||A||_2 there, in units of m eps
    if bool(differ.any()):
        ev = torch.linalg.eigvalsh(flat[differ].double())
        band = ev[:, 0].abs() / ev.abs().amax(-1) / (m * eps)
        lmin = band.max().item()
        check(lmin <= SPD_BORDER,
              f"{name} {tag}: NaN lanes differ on {int((band > SPD_BORDER).sum())} "
              f"matrices whose |lambda_min| / ||A|| exceeds {SPD_BORDER} m eps "
              f"(worst {lmin:.3f} m eps)")
    check(bool(nan_k[planted].all()), f"{name} {tag}: planted non-SPD not NaN")
    eta = inv_backward_error(A, Xk)
    eta_p = inv_backward_error(A, Xp)
    check(eta <= 1e3 * eps, f"{name} {tag}: backward error {eta:.3e}")
    keep = ~differ
    a, r = max_err(Xk.reshape(nm, m, m)[keep], Xp.reshape(nm, m, m)[keep])
    row = {"m": m, "count": nm, "abs": a, "rel": r, "eta": eta, "eta_plain": eta_p,
           "nan": int(nan_k.sum()), "nan_differ_at_boundary": int(differ.sum()),
           "differ_lmin_m_eps": lmin}
    if name == "spd_inv":   # a thread or a warp a matrix (csrc/spd_inv.cu spd_route)
        row["route"] = kernels.spd_inv_route(m, A.dtype)._asdict()
    if timing:
        row["ms"] = time_ms(lambda: kernels.spd_inv(A))
        row["graph_ms"] = graph_ms(lambda: kernels.spd_inv(A), n=10, reps=3)
        if name == "spd_inv_blocked":
            row["profile"] = _spdb_split(A)
        row["plain_ms"] = time_ms(lambda: _spd_inv(A), reps=5, warm=1)
        row["library_ms"] = time_ms(
            lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(A)[0]), reps=5, warm=1)
        row["bound_ms"], row["bound_by"] = bound(2 * nbytes(A), nm * m ** 3, A.dtype)
    return name, row


def _spdb_split(A, calls=5):
    """spd_inv_blocked's device milliseconds by sub-kernel
    (csrc/spd_inv_blocked.cu spdb_panel/syrk/trtri/lauum) from a
    torch.profiler window over ``calls`` calls: per launch the profiler
    recorded, and per call at kernels.spdb_launch_plan's launches (the
    profiler may drop a window's first records)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels

    top = _profile_window(lambda: [kernels.spd_inv(A) for _ in range(calls)])["top"]
    plan = kernels.spdb_launch_plan(A.shape[-1])
    split = {}
    for step in ("panel", "syrk", "trtri", "lauum"):
        ev = [e for e in top if f"spdb_{step}_kernel" in e["name"]]
        seen = sum(e["count"] for e in ev)
        per = sum(e["device_ms"] for e in ev) / max(seen, 1)
        n = sum(1 for k, _ in plan if k == f"spdb_{step}")
        split[step] = {"ms_per_launch": per, "launches": n, "ms_per_call": per * n,
                       "recorded": seen}
    return split


def check_spd_alone(dev):
    """spd_inv alone, both dtypes, at the dual blocks' and the spines'
    orders of both its routes, m = 8, 16 (a thread a matrix), 17, 33, 54,
    79, 120 (a warp a matrix), 4096 matrices each, and at the long spines'
    orders m = 124, 204, 254, 374 (N = 24, 40, 50, 74 at free time;
    spd_inv_blocked), 10 each: SPD (eigenvalues 1e-2..1 of a random
    basis), one with lambda_min near zero (1e-6), one non-SPD from its
    first pivot, one from its last pivot and one whose single negative
    eigenvalue (-1e-3) shows only in a late pivot. Before them,
    kernels.spd_inv_route against the built library's route at m = 1-120."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels

    for dtype in (torch.float32, torch.float64):
        for m in range(1, kernels.SPD_INV_MAX_M + 1):
            py, lib = kernels.spd_inv_route(m, dtype), kernels.spd_inv_route_of_library(m, dtype)
            check(py == lib, f"spd_inv_route m={m} {dtype}: {py} != the library's {lib}")
    t0 = time.time()
    for m, count in ((8, 4096), (16, 4096), (17, 4096), (33, 4096), (54, 4096), (79, 4096),
                     (120, 4096), (124, 10), (204, 10), (254, 10), (374, 10)):
        if count == 10:
            rng = np.random.RandomState(m)
            Q, _ = np.linalg.qr(rng.randn(10, m, m))
            lam = 10.0 ** rng.uniform(-2, 0, (10, m))
            Q, lam = torch.as_tensor(Q, device=dev), torch.as_tensor(lam, device=dev)
        else:   # made on the card from a seed: a CPU QR of 4096 matrices is slow
            g = torch.Generator(device=dev).manual_seed(m)
            Q, _ = torch.linalg.qr(torch.randn(count, m, m, generator=g, device=dev,
                                               dtype=torch.float64))
            lam = 10.0 ** (-2.0 * torch.rand(count, m, generator=g, device=dev,
                                             dtype=torch.float64))
        lam[3, 0], lam[8, 0] = 1e-6, -1e-3
        A = (Q * lam[:, None, :]) @ Q.transpose(1, 2)
        A = (A + A.transpose(1, 2)) / 2
        A[5, 0, 0] = -1.0
        Lc = torch.linalg.cholesky(A[9])
        A[9, m - 1, m - 1] -= Lc[m - 1, m - 1] ** 2 + 1.0   # the last pivot becomes -1
        for dtype in (torch.float64, torch.float32):
            At = A.to(dtype).contiguous()
            tag = f"alone m={m} {'f64' if dtype == torch.float64 else 'f32'}"
            name, row = check_spd(At, tag, torch.tensor([5, 8, 9], device=dev), False)
            log(f"[kernels] {name} {tag}: " + json.dumps(row))
        del Q, lam, A
    log(f"[kernels] spd alone {time.time() - t0:.1f} s")


def _al_args(x):
    """kernels.newton_al_solve's arguments at the inputs ``x``."""
    return (x["L"], x["bnd"], *x["asm"][:3], x["asm"][4], x["Qinv"], x["Yq"], x["Sinv"],
            x["rhs1"], x["rhs2"], x["ladder"], x["dd"], x["opt"].delta_d, x["opt"].n_refine)


def _provider_args(x, lanes=None):
    """kernels.obca_kkt_provider's arguments at the inputs ``x``, on their
    first ``lanes`` lanes (all where None)."""
    st = x["st"]
    sel = (lambda t: t) if lanes is None else (lambda t: t[:lanes].contiguous())
    return (x["spec"], x["L"].lay, x["ops"].ds, *[sel(t) for t in (
        st.zv, x["data_flat"], st.sf, st.scE, st.scD, st.y, x["w_d"])])


def _provider_plan(x, B):
    """The provider's launch plan for B lanes of ``x`` (the built
    library's)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels

    return kernels.provider_launch_plan(x["spec"], x["L"].lay, x["data_flat"].shape[1], B,
                                        x["st"].zv.dtype)


def _provider_bytes(args, out):
    """The tensors the provider must move: its inputs (``ds`` among them)
    and its outputs. The row plan is the design's table, not the
    function's input, and is left out."""
    return [*args[2:], *out]


def _provider_shape(x, lanes=None):
    """The provider's times, bound and launch plan on the first ``lanes``
    lanes of ``x`` (a main path's shape), held to its plain version."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels

    args = _provider_args(x, lanes)
    fn = lambda: kernels.obca_kkt_provider(*args)
    out = fn()
    B = args[3].shape[0]
    dtype = args[3].dtype
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    rel = max(max_err(o, getattr(x["bnd"], f)[:B])[1] for f, o in zip(out._fields, out))
    check(rel <= tol, f"obca_kkt_provider at {B} lanes: rel {rel:.3e} > {tol:g}")
    plan = _provider_plan(x, B)
    b_ms, b_by = bound(nbytes(*_provider_bytes(args, out)),
                       _flops("obca_kkt_provider", x["L"], B, 1, x["opt"]), dtype)
    return {"lanes": B, "rel": rel, "ms": time_ms(fn), "graph_ms": graph_ms(fn, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "ctas_per_lane": 1 + plan.spine_ctas + plan.block_ctas,
            "plan": plan._asdict()}


def _schur_shape(x, lanes=None):
    """newton_schur's graph time, bound and launch plan on the first
    ``lanes`` lanes of ``x`` (a main path's shape), held to its plain
    version."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels

    sel = (lambda t: t) if lanes is None else (lambda t: t[:lanes].contiguous())
    L = x["L"]
    args = (L, sel(x["Qinv"]), sel(x["asm"][4]), sel(x["asm"][3]), sel(x["ladder"]))
    fn = lambda: kernels.newton_schur(*args)
    kY, kS = fn()
    B, R = args[4].shape
    dtype = kS.dtype
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    rel = max(max_err(kY, sel(x["Yq"]))[1], max_err(kS, sel(x["Smat"]))[1])
    check(rel <= tol, f"newton_schur at {B} lanes: rel {rel:.3e} > {tol:g}")
    b_ms, b_by = bound(nbytes(*args[1:], kY, kS), _flops("newton_schur", L, B, R, x["opt"]),
                       dtype)
    plan = kernels.schur_launch_plan(x["spec"], L.lay, R, B, dtype)
    return {"lanes": B, "rel": rel, "ms": time_ms(fn), "graph_ms": graph_ms(fn, reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "tiles": plan.tiles, "rows": plan.rows}


def check_kernels(x, tag, timing):
    """Each kernel against its plain version on the inputs ``x``; returns
    per-kernel errors and, with ``timing``, times and bounds."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import qr
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
        _spd_inv)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.linesearch import (
        step_linesearch_plain)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
        newton_al_solve_plain, newton_assemble_plain, newton_schur_plain)

    st, bnd, L, ops, opt = x["st"], x["bnd"], x["L"], x["ops"], x["opt"]
    dtype = st.zv.dtype
    eps = torch.finfo(dtype).eps
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    B, R = x["ladder"].shape
    rows = {}

    def timed(name, kfn, pfn, in_out, plain_reps=5, lib=None, flops=None, graph_n=0):
        if not timing:
            return
        r = rows[name]
        r["ms"] = time_ms(kfn)
        if graph_n:   # device time alone: graph_n calls captured in one graph
            r["graph_ms"] = graph_ms(kfn, n=graph_n, reps=3)
        r["plain_ms"] = time_ms(pfn, reps=plain_reps, warm=1)
        r["library_ms"] = None if lib is None else time_ms(lib, reps=plain_reps, warm=1)
        r["bound_ms"], r["bound_by"] = bound(nbytes(*in_out), flops, dtype)

    # ---- provider: against its plain version, a graph replay against the
    # eager call; its launch plan recorded
    args = _provider_args(x)
    kb = kernels.obca_kkt_provider(*args)
    worst = (0.0, 0.0, "")
    for f in bnd._fields:
        a, r = max_err(getattr(kb, f), getattr(bnd, f))
        if r > worst[1]:
            worst = (a, r, f)
        check(r <= tol, f"obca_kkt_provider {tag}: field {f} rel {r:.3e} > {tol:g}")
    plan = _provider_plan(x, B)
    check(all(_bit_equal(g_, k_) for g_, k_ in zip(
              _graph_once(lambda: kernels.obca_kkt_provider(*args)), kb)),
          f"obca_kkt_provider {tag}: a graph replay differs from the eager call")
    rows["obca_kkt_provider"] = {"abs": worst[0], "rel": worst[1], "worst": worst[2],
                                 "plan": plan._asdict()}
    plain = x["solve"].provider.plain
    timed("obca_kkt_provider", lambda: kernels.obca_kkt_provider(*args),
          lambda: plain(st.zv, x["data"], st.sf, st.scE, st.scD, st.y, x["w_d"]),
          _provider_bytes(args, kb),
          flops=_flops("obca_kkt_provider", L, B, R, opt), graph_n=20)

    # ---- newton_assemble, the full call and the QR rung's W-only call
    a_args = (L, bnd, x["sigma"], x["sgn_eff"], x["ladder"], x["dd"])
    ka = kernels.newton_assemble(*a_args)
    kw = kernels.newton_assemble(*a_args, w_only=True)
    rel, ab = 0.0, 0.0
    for name, k_, p_ in zip(("Wpp", "Wpq", "Wqq", "Gpp0", "Gpq0", "Gqq", "Wpp (w_only)",
                             "Wpq (w_only)", "Wqq (w_only)"), ka + kw, x["asm"] + x["asm"][:3]):
        a, r = max_err(k_, p_)
        check(r <= tol, f"newton_assemble {tag}: {name} rel {r:.3e} > {tol:g}")
        rel, ab = max(rel, r), max(ab, a)
    rows["newton_assemble"] = {"abs": ab, "rel": rel,
                               "ctas_per_lane": kernels.assemble_ctas_per_lane(L.np_, L.K)}
    sig_sp = x["sigma"][:, L.m_id:L.m_id + L.mD_sp, None]

    def spine_products():
        """the assembly's dominant work: Hpp + (JD_sp sigma)^T JD_sp and JE_sp^T JE_sp"""
        torch.baddbmm(bnd.Hpp, (bnd.JD_sp * sig_sp).transpose(1, 2), bnd.JD_sp)
        torch.bmm(bnd.JE_sp.transpose(1, 2), bnd.JE_sp)

    timed("newton_assemble", lambda: kernels.newton_assemble(*a_args),
          lambda: newton_assemble_plain(ops, bnd, x["sigma"], x["sgn_eff"],
                                        x["ladder"], x["dd"]),
          [bnd.Hpp, bnd.Hpq_c, bnd.Hqq, bnd.JE_sp, bnd.JEb_th, bnd.JEb_q,
           bnd.JD_sp, bnd.JDb_p, bnd.JDb_q, x["sigma"], x["sgn_eff"], x["ladder"], *ka],
          lib=spine_products, flops=_flops("newton_assemble", L, B, R, opt), graph_n=20)

    # ---- spd_inv (and spd_inv_blocked above m = 120), m = bq and m = np,
    # with planted non-SPD matrices
    for label, A in (("m=bq", x["asm"][5]), ("m=np", x["Smat"])):
        A = A.clone()
        m = A.shape[-1]
        flat = A.reshape(-1, m, m)
        nm = flat.shape[0]
        planted = torch.unique(torch.tensor([0, 7, nm // 2, nm - 1],
                                            device=A.device).clamp(max=nm - 1))
        big = flat.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
        flat[planted, 1, 1] = -10.0 * big[planted]
        name, row = check_spd(A, f"{tag} {label}", planted, timing)
        spd = rows.setdefault(name, {"abs": 0.0, "rel": 0.0})
        spd[label] = row
        spd["abs"], spd["rel"] = max(spd["abs"], row["abs"]), max(spd["rel"], row["rel"])
    if timing:
        for name in SPD:
            if name in rows:
                parts = [rows[name][lb] for lb in ("m=bq", "m=np") if lb in rows[name]]
                for key in ("ms", "graph_ms", "plain_ms", "library_ms", "bound_ms"):
                    rows[name][key] = sum(r[key] for r in parts)
                rows[name]["bound_by"] = parts[-1]["bound_by"]

    # ---- newton_schur: its launch plan, the outputs' SHA-1s (to hold two
    # checkouts' kernels to the same bits) and a graph replay
    s_args = (L, x["Qinv"], x["asm"][4], x["asm"][3], x["ladder"])
    kY, kS = kernels.newton_schur(*s_args)
    aY, rY = max_err(kY, x["Yq"])
    aS, rS = max_err(kS, x["Smat"])
    check(max(rY, rS) <= tol, f"newton_schur {tag}: rel {max(rY, rS):.3e}")
    check(all(_bit_equal(g_, k_) for g_, k_ in zip(
              _graph_once(lambda: kernels.newton_schur(*s_args)), (kY, kS))),
          f"newton_schur {tag}: a graph replay differs from the eager call")
    rows["newton_schur"] = {"abs": max(aY, aS), "rel": max(rY, rS),
                            "sha1": {"Yq": sha1(kY), "S": sha1(kS)},
                            "plan": kernels.schur_launch_plan(x["spec"], L.lay, R, B,
                                                              dtype)._asdict()}
    timed("newton_schur", lambda: kernels.newton_schur(*s_args),
          lambda: newton_schur_plain(ops, *s_args[1:]),
          [x["Qinv"], x["asm"][4], x["asm"][3], x["ladder"], kY, kS],
          flops=_flops("newton_schur", L, B, R, opt), graph_n=20)

    # ---- newton_al_solve
    n_args = _al_args(x)
    ksol, kgood = kernels.newton_al_solve(*n_args)
    x64 = _float64(x)
    exact = newton_al_solve_plain(
        x64["ops"], x64["bnd"], *x64["asm"][:3], x64["asm"][4], x64["Qinv"], x64["Yq"],
        x64["Sinv"], x64["rhs1"], x64["rhs2"], x64["ladder"], x["dd"], opt.delta_d,
        opt.n_refine)[0]
    rows["newton_al_solve"] = check_saddle_solve(
        "newton_al_solve", tag, x64, ksol, kgood, x["sols"], x["goods"], exact)
    del exact
    # the route (csrc/newton.cu al_route) the wrapper and the library pick
    route = kernels.al_solve_route(L.lay, R, dtype)
    lib_route = kernels.al_solve_route_of_library(x["spec"], L.lay, R, dtype)
    check(route == lib_route, f"newton_al_solve {tag}: route {route} != the library's {lib_route}")
    rows["newton_al_solve"]["route"] = route._asdict()
    # a NaN in one (lane, rung)'s Sinv and in another lane's Qinv rejects
    # those rungs alone, on both sides
    lb, lq = 0, B // 2
    Sbad, Qbad = x["Sinv"].clone(), x["Qinv"].clone()
    Sbad[lb, 0, 1, 2] = float("nan")
    Qbad[lq, R - 1, 0, 1, 1] = float("nan")
    b_args = n_args[:6] + (Qbad, x["Yq"], Sbad) + n_args[9:]
    kg_bad = kernels.newton_al_solve(*b_args)[1]
    pg_bad = newton_al_solve_plain(ops, *b_args[1:])[1]
    others = torch.ones_like(kgood)
    others[lb, 0] = others[lq, R - 1] = False
    check(bool((kg_bad == pg_bad).all()) and not bool(kg_bad[lb, 0])
          and not bool(kg_bad[lq, R - 1]) and bool((kg_bad[others] == kgood[others]).all()),
          f"newton_al_solve {tag}: a planted NaN not rejected on its rung alone")
    timed("newton_al_solve", lambda: kernels.newton_al_solve(*n_args),
          lambda: newton_al_solve_plain(ops, *n_args[1:]),
          [bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, *x["asm"][:3], x["asm"][4], x["Qinv"],
           x["Yq"], x["Sinv"], x["rhs1"], x["rhs2"], x["ladder"], ksol, kgood],
          flops=_flops("newton_al_solve", L, B, R, opt), graph_n=20)

    # ---- step_linesearch: both routes at these widths, planted lanes, a
    # graph replay (check_linesearch); timed on the main path's route
    rows["step_linesearch"] = check_linesearch(x, tag)
    if timing:
        lanes = torch.arange(B, device=st.zv.device)
        l_args, l_plain, _ = _ls_lanes(x, lanes)
        kl = kernels.step_linesearch(*l_args)
        trials = rows["step_linesearch"]["trials"] = _ls_trials(x)
        # bytes: one rung of sols and of the ladder (the picked one) is read
        timed("step_linesearch", lambda: kernels.step_linesearch(*l_args),
              lambda: step_linesearch_plain(*l_plain),
              [l_args[2][:, 0], l_args[3], l_args[4][:, 0], *l_args[5:14], l_args[14].JD_sp,
               l_args[14].JDb_p, l_args[14].JDb_q, *l_args[15:], *kl],
              flops=_flops("step_linesearch", L, B, R, opt, count=trials["needed"]),
              graph_n=20)

    # ---- kkt_qr (the QR rescue rungs run the fix-time variants of the
    # fix step and the rollout; the open loop has none); also at S = 4
    if ((x["spec"].variant != "free" or x["spec"].coupled_motion)
            and not x["kind"].startswith("open")):
        q_args = (ops, bnd, *x["asm"][:3], x["rhs1"], x["rhs2"], x["ladder"], opt.delta_d)
        qsol, qgood = qr.kkt_qr_plain(*q_args)
        ksol, kgood = kernels.kkt_qr(*q_args)
        rows["kkt_qr"] = check_saddle_solve("kkt_qr", tag, x64, ksol, kgood, qsol, qgood)
        # a NaN planted in W rejects the rungs of its lanes on both sides
        Wbad = x["asm"][0].clone()
        bad = torch.arange(0, B, max(B // 4, 1), device=Wbad.device)
        Wbad[bad, 1, 1] = float("nan")
        bargs = (ops, bnd, Wbad, *x["asm"][1:3], x["rhs1"], x["rhs2"], x["ladder"],
                 opt.delta_d)
        kg_bad = kernels.kkt_qr(*bargs)[1]
        pg_bad = qr.kkt_qr_plain(*bargs)[1]
        check(bool((kg_bad == pg_bad).all()) and not bool(kg_bad[bad].any()),
              f"kkt_qr {tag}: planted NaN not rejected like the plain version")
        if timing:
            K_, _ = qr.saddle_matrix(ops, bnd, *x["asm"][:3], x["ladder"], opt.delta_d)
            rhs = torch.cat([x["rhs1"], x["rhs2"]], 1)[:, None, :, None].expand(
                K_.shape[:3] + (1,))

            def library():
                Q, Rm = torch.linalg.qr(K_)
                return torch.linalg.solve_triangular(Rm, Q.transpose(-1, -2) @ rhs,
                                                     upper=True)

            timed("kkt_qr", lambda: kernels.kkt_qr(*q_args),
                  lambda: qr.kkt_qr_plain(*q_args),
                  [bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, *x["asm"][:3], x["rhs1"],
                   x["rhs2"], x["ladder"], ksol, kgood],
                  plain_reps=2, lib=library, flops=_flops("kkt_qr", L, B, R, opt), graph_n=2)
            del K_, rhs
            rows["kkt_qr"]["profile"] = _profile_window(lambda: kernels.kkt_qr(*q_args))["top"]
        if x["kind"] == "fix_terminal":
            rows["kkt_qr"]["sweep_batch"] = _qr_sweep_batch(x, 16, tag, timing)
    torch.cuda.synchronize()
    return rows


def _ls_lanes(x, idx, plant=False):
    """(kernel arguments, plain arguments, planted lanes) of step_linesearch
    on the lanes ``idx`` of the inputs ``x`` (a slice or a tiling, copied).
    With ``plant``, the first four lanes of the selection whose step is
    not bad are planted, in order: a NaN in the picked rung, no good rung,
    every trial rejected (a NaN in cE: theta0 is NaN), a_s = 0 (a zero
    slack whose step is negative); none of them takes a step."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels

    st, bnd = x["st"], x["bnd"]
    sel = lambda t: t[idx].contiguous()
    sols, goods, s, cI = sel(x["sols"]), sel(x["goods"]), sel(st.s), sel(x["cI"])
    b = type(bnd)(*[sel(t) for t in bnd])
    data = type(x["data"])(*[sel(t) for t in x["data"]])
    planted = []
    if plant:
        R = goods.shape[1]
        first = torch.argmax(goods.int(), 1)
        pick = torch.where(goods.any(1), first, torch.full_like(first, R - 1))
        sol = sols[torch.arange(len(idx), device=sols.device), pick]
        fine = goods.any(1) & torch.isfinite(sol).all(1)
        planted = torch.nonzero(fine).flatten()[:4].tolist()
        for kind, i in enumerate(planted):
            if kind == 0:
                sols[i, int(pick[i]), 3] = float("nan")
            elif kind == 1:
                goods[i] = False
            elif kind == 2:
                b.cE[i, 0] = float("nan")
            else:
                s[i, 5], cI[i, 5] = 0.0, -1e3
    head = (x["ops"], x["opt"], sols, goods, sel(x["ladder"]), sel(st.zv), s, sel(st.y),
            sel(st.w), sel(st.mu_b), sel(st.delta), cI, b.cE, b.f, b, sel(x["sgn_eff"]),
            sel(x["id_off"]))
    tail = (sel(st.sf), sel(st.scE), sel(st.scD))
    return head + (kernels.pack_obca_data(data),) + tail, head + (data,) + tail, planted


def _ls_prelude(ops, opt, sols, goods, ladder, zv, s, w, mu_b, cI, cE, f0, bnd, sgn_eff):
    """What step_linesearch computes before its trials, by the plain
    version's formulas (solver/linesearch.py): the pick (first good rung,
    else the last), dz, whether the step is bad (no good rung or a
    non-finite direction), ds, dw, a_s, a_w, phi0 and theta0."""
    import torch

    n, R, B = ops.L.n, ladder.shape[1], zv.shape[0]
    any_good = goods.any(1)
    first = torch.argmax(goods.to(torch.int32), dim=1)
    pick = torch.where(any_good, first, torch.full_like(first, R - 1))
    sol = sols[torch.arange(B, device=zv.device), pick]
    bad = ~(any_good & torch.isfinite(sol).all(1))
    dz = sol[:, :n]
    ds = ops.f_ji(bnd, dz, sgn_eff) + (cI - s)
    mu = mu_b[:, None]
    dw = -(s * w - mu + w * ds) / s
    tau = torch.clamp(1.0 - mu, min=opt.tau_min)
    one = torch.ones_like(s)
    neg_s, neg_w = ds < 0, dw < 0
    a_s = torch.where(neg_s, -tau * s / torch.where(neg_s, ds, -one), one).amin(1)
    a_w = torch.where(neg_w, -tau * w / torch.where(neg_w, dw, -one), one).amin(1)
    phi0 = f0 - mu_b * torch.sum(torch.log(s), 1)
    th0 = torch.sum(torch.abs(cE), 1) + torch.sum(torch.abs(cI - s), 1)
    return dict(pick=pick, sol=sol, bad=bad, dz=dz, ds=ds, dw=dw,
                a_s=torch.clamp(a_s, max=1.0), a_w=torch.clamp(a_w, max=1.0), phi0=phi0, th0=th0)


def _ls_trial(ops, pre, j, zv, s, mu_b, sgn_eff, id_off, data, sf, scE, scD):
    """(phi, theta) of trial j, alpha_j = a_s 2^-j, on every lane, from the
    prelude ``pre`` (_ls_prelude)."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import obca

    spec = ops.L.spec
    a = (pre["a_s"] * 0.5 ** j)[:, None]
    zt = zv + a * pre["dz"]
    st_ = s + a * pre["ds"]
    z = obca.unravel_z(spec, zt * ops.ds)
    cEs = scE * obca.eq_constraints(spec, data, z)
    cIs = torch.cat([sgn_eff * zt[:, ops.id_idx] + id_off,
                     scD * obca.ineq_constraints_dense(spec, data, z)], 1)
    phi = sf * obca.objective(spec, data, z) - mu_b * torch.sum(torch.log(st_), 1)
    th = torch.sum(torch.abs(cEs), 1) + torch.sum(torch.abs(cIs - st_), 1)
    return phi, th


def _ls_accept(phi, th, pre):
    """The filter rule: a trial with a finite phi that cuts theta or phi."""
    import torch

    return torch.isfinite(phi) & ((th <= (1.0 - 1e-5) * pre["th0"])
                                  | (phi <= pre["phi0"] - 1e-5 * pre["th0"]))


def _ls_trials(x):
    """The trials of step_linesearch on every lane of the inputs ``x``:
    those the filter search needs (per lane up to the first accepted one,
    all n_backtracks where none is, none where the step is bad), the bad
    lanes, and those the kernel evaluates on its route (the group route
    whole rounds of ``groups`` up to the one holding the first accepted
    trial, the spread route every trial of a lane whose step is not
    bad)."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels

    B = x["st"].zv.shape[0]
    (ops, opt, sols, goods, ladder, zv, s, _, w, mu_b, _, cI, cE, f0, bnd, sgn, id_off, data,
     sf, scE, scD) = _ls_lanes(x, torch.arange(B, device=x["st"].zv.device))[1]
    pre = _ls_prelude(ops, opt, sols, goods, ladder, zv, s, w, mu_b, cI, cE, f0, bnd, sgn)
    nb = opt.n_backtracks
    need = torch.full((B,), nb, dtype=torch.long, device=zv.device)
    for j in reversed(range(nb)):
        phi, th = _ls_trial(ops, pre, j, zv, s, mu_b, sgn, id_off, data, sf, scE, scD)
        need = torch.where(_ls_accept(phi, th, pre), j + 1, need)
    need = torch.where(pre["bad"], 0, need)
    route = kernels.ls_route(ops.L.lay, x["data_flat"].shape[1], B, nb, zv.dtype)
    G = route.groups if route.route == "group" else nb
    return {"needed": int(need.sum()), "bad_lanes": int(pre["bad"].sum()),
            "evaluated": int(((need + G - 1) // G * G).clamp(max=nb).sum())}


def _bit_equal(a, b):
    import torch

    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def _graph_once(fn):
    """The outputs of one call of ``fn`` captured in a CUDA graph and
    replayed."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(g):
            out = fn()
    finally:
        if gc_on:
            gc.enable()
    g.replay()
    torch.cuda.synchronize()
    return out


def check_linesearch(x, tag):
    """step_linesearch against its plain version on the inputs ``x`` (see
    the tolerances above), on both routes at these widths: the main path's
    on every lane, clean and with four planted lanes (_ls_lanes), and the
    other route, planted, on a slice of LS_SPREAD_CTAS // n_backtracks
    lanes (spread) or a tiling of one lane more (group); the route of each
    call equal to the library's, the planted lanes without a step, and a
    CUDA graph replay of each call bit-equal to the eager call. Returns
    the report row."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.linesearch import (
        step_linesearch_plain)

    L, opt, dev = x["L"], x["opt"], x["st"].zv.device
    dtype = x["st"].zv.dtype
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    B, nb = x["ladder"].shape[0], opt.n_backtracks
    width = x["data_flat"].shape[1]
    main = kernels.ls_route(L.lay, width, B, nb, dtype)
    k = kernels.LS_SPREAD_CTAS // nb
    other = (torch.arange(min(B, k), device=dev) if main.route == "group"
             else torch.arange(k + 1, device=dev) % B)
    lanes = torch.arange(B, device=dev)
    row = {"abs": 0.0, "rel": 0.0, "route": main._asdict()}
    for label, idx, plant in (("main", lanes, False), ("main planted", lanes, True),
                              ("other planted", other, True)):
        what = f"step_linesearch {tag} {label}"
        kargs, pargs, planted = _ls_lanes(x, idx, plant)
        rt = kernels.ls_route(L.lay, width, len(idx), nb, dtype)
        lib_rt, work = kernels.ls_route_of_library(x["spec"], L.lay, len(idx), nb, dtype)
        check(rt == lib_rt and work == kernels.ls_work_elems(L.lay, nb),
              f"{what}: route {rt} != the library's {lib_rt} (workspace {work})")
        check((rt.route == main.route) == label.startswith("main"), f"{what}: route {rt.route}")
        n0 = kernels.launches["step_linesearch"]
        kl = kernels.step_linesearch(*kargs)
        torch.cuda.synchronize()
        check(kernels.launches["step_linesearch"] == n0 + 1, f"{what}: not launched")
        pl = step_linesearch_plain(*pargs)
        for name, k_, p_ in zip(("zv", "s", "y", "w", "delta"), kl, pl):
            a, r = max_err(k_, p_)
            check(r <= tol, f"{what} ({rt.route}): {name} rel {r:.3e} > {tol:g}")
            row["abs"], row["rel"] = max(row["abs"], a), max(row["rel"], r)
        if plant:
            pl_ = torch.tensor(planted, dtype=torch.long, device=dev)
            check(len(planted) >= min(2, len(idx)) and torch.equal(kl[0][pl_], kargs[5][pl_])
                  and torch.equal(kl[1][pl_], kargs[6][pl_]),
                  f"{what}: a planted lane took a step (planted {planted})")
        check(all(_bit_equal(g, e) for g, e in
                  zip(_graph_once(lambda: kernels.step_linesearch(*kargs)), kl)),
              f"{what} ({rt.route}): a graph replay differs from the eager call")
        if label != "main":
            row[label] = {"route": rt.route, "lanes": len(idx), "groups": rt.groups,
                          "group_warps": rt.group_warps, "planted": len(planted)}
    return row


def _qr_sweep_batch(x, lanes, tag, timing):
    """kkt_qr on the first ``lanes`` lanes x R of the inputs ``x`` (a
    sweep rescue rung's batch: ~30 matrices) against the plain version as
    at the full batch (check_saddle_solve: float64 within 1e-9, float32
    by the residual); with ``timing``, times of the kernel, the plain
    version and the library QR, and the bound."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import qr

    sl = lambda t: t[:lanes].contiguous()
    xs = dict(x, bnd=type(x["bnd"])(*[sl(t) for t in x["bnd"]]),
              asm=tuple(sl(t) for t in x["asm"]))
    for k in ("rhs1", "rhs2", "ladder", "Qinv", "Yq", "Sinv"):
        xs[k] = sl(x[k])
    ops, opt, L, bnd = xs["ops"], xs["opt"], xs["L"], xs["bnd"]
    W = xs["asm"][:3]
    q_args = (ops, bnd, *W, xs["rhs1"], xs["rhs2"], xs["ladder"], opt.delta_d)
    ksol, kgood = kernels.kkt_qr(*q_args)
    psol, pgood = qr.kkt_qr_plain(*q_args)
    B, R = xs["ladder"].shape
    row = check_saddle_solve("kkt_qr", f"{tag} sweep batch", _float64(xs), ksol, kgood,
                             psol, pgood)
    row["matrices"] = B * R
    K_, _ = qr.saddle_matrix(ops, bnd, *W, xs["ladder"], opt.delta_d)
    row["dense"] = check_qr_dense(K_.contiguous(), torch.cat([xs["rhs1"], xs["rhs2"]], 1),
                                  L.n, f"{tag} sweep batch", timing, assembled=(ksol, kgood))
    if not timing:
        return row
    rhs = torch.cat([xs["rhs1"], xs["rhs2"]], 1)[:, None, :, None].expand(K_.shape[:3] + (1,))

    def library():
        Q, Rm = torch.linalg.qr(K_)
        return torch.linalg.solve_triangular(Rm, Q.transpose(-1, -2) @ rhs, upper=True)

    row.update({"ms": time_ms(lambda: kernels.kkt_qr(*q_args)),
                "graph_ms": graph_ms(lambda: kernels.kkt_qr(*q_args), n=10, reps=3),
                "profile": _profile_window(lambda: kernels.kkt_qr(*q_args))["top"],
                "plain_ms": time_ms(lambda: qr.kkt_qr_plain(*q_args), reps=5, warm=1),
                "library_ms": time_ms(library, reps=5, warm=1)})
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, *W, *q_args[5:8], ksol, kgood),
        _flops("kkt_qr", L, B, R, opt), ksol.dtype)
    return row


def _dense_residual(K, rhs, sol):
    """||K sol - rhs||_inf / ||rhs||_inf of every (lane, rung), in float64."""
    r64 = rhs.double()[:, None]
    res = (K.double() @ sol.double()[..., None])[..., 0] - r64
    return res.abs().amax(-1) / r64.abs().amax(-1).clamp(min=1e-300)


def check_qr_dense(K, rhs, n, tag, timing, assembled=None):
    """kkt_qr_dense (the QR solve of assembled saddle matrices K (B, R, M,
    M), rhs (B, M)) against its plain version: the rung flags equal; float64
    within 1e-9; float32 by the residual rule of check_saddle_solve (every
    accepted (lane, rung) at most 3x the plain version's residual + 1e3
    eps). ``assembled``: kkt_qr's (sol, good) on the same matrices, which
    the dense route must equal bit for bit or hold to the same rule. With
    ``timing``: ms, graph ms, plain ms, the library call's ms
    (linalg.qr + solve_triangular) and the bound."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import qr

    B, R, M = K.shape[0], K.shape[1], K.shape[-1]
    dtype = K.dtype
    eps = torch.finfo(dtype).eps
    ksol, kgood = kernels.kkt_qr_dense(K, rhs, n)
    psol, pgood = qr.kkt_qr_dense_plain(K, rhs, n)

    def hold(name, ksol, kgood, psol, pgood):
        check(bool((kgood == pgood).all()),
              f"{name} {tag}: good differs on {int((kgood != pgood).sum())} rungs")
        a, r = max_err(ksol, psol)
        g = kgood & pgood
        rk, rp = _dense_residual(K, rhs, ksol)[g], _dense_residual(K, rhs, psol)[g]
        lim = 3.0 * rp + 1e3 * eps
        if dtype == torch.float64:
            check(r <= 1e-9, f"{name} {tag}: rel {r:.3e} > 1e-09")
        else:
            check(bool((rk <= lim).all()),
                  f"{name} {tag}: residual above its limit on {int((~(rk <= lim)).sum())} "
                  f"of {int(g.sum())} accepted rungs")
        return {"abs": a, "rel": r, "good": int(kgood.sum()),
                "residual_max": rk.max().item() if rk.numel() else 0.0,
                "residual_max_plain": rp.max().item() if rp.numel() else 0.0}

    row = hold("kkt_qr_dense", ksol, kgood, psol, pgood)
    row.update(matrices=B * R, M=M)
    if assembled is not None:
        asol, agood = assembled
        same = _bit_equal(ksol, asol) and bool((kgood == agood).all())
        row["bit_equal_assembled"] = same
        if not same:
            row["vs_assembled"] = hold("kkt_qr_dense vs kkt_qr", ksol, kgood, asol, agood)
    if timing:
        b = rhs[:, None, :, None].expand(K.shape[:3] + (1,))

        def library():
            Q, Rm = torch.linalg.qr(K)
            return torch.linalg.solve_triangular(Rm, Q.transpose(-1, -2) @ b, upper=True)

        fn = lambda: kernels.kkt_qr_dense(K, rhs, n)
        row.update(ms=time_ms(fn), graph_ms=graph_ms(fn, n=10, reps=3),
                   plain_ms=time_ms(lambda: qr.kkt_qr_dense_plain(K, rhs, n), reps=5, warm=1),
                   library_ms=time_ms(library, reps=5, warm=1))
        row["bound_ms"], row["bound_by"] = bound(
            nbytes(K, rhs, ksol, kgood), B * R * (4 * M ** 3 // 3 + 8 * M * M + 2 * n * n), dtype)
    log(f"[kkt_qr_dense] {tag} ({dtype}): " + json.dumps(row, default=float))
    return row


def _freeze_inputs(kind, dtype, dev, seed):
    """(old, new, active) of ipm_freeze at a main path's shapes: ``kind``
    "fix" is the fix step's 256 fixture rows x 5 candidates (1280 lanes),
    "runner5" one fixture row's 5 candidates (the host runner's fix-time
    replan), "runner2" demo1's entry problem on 2 lanes (its free-time
    replan), "N74" the open loop's 5 candidate lanes at N = 74; old after
    3 plain iterations, new one iteration on, active a seeded 60% of the
    lanes with the first lane active and the last not."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        ENTRY_OPTIONS, FIX6_OPTIONS, demo1_problem, fix_fixture_batch, openloop_n74_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    if kind == "runner2":
        spec, data, _, _ = demo1_problem(dtype, dev)
        data = type(data)(*[f.expand((2,) + f.shape[1:]).contiguous() for f in data])
        solve = make_obca_solver(spec, ENTRY_OPTIONS, impl="plain")
        z0 = None
    else:
        if kind == "N74":
            spec, data, cands, opt = openloop_n74_inputs(dtype, dev)
        else:
            spec, _, data, cands = fix_fixture_batch(256 if kind == "fix" else 1, dtype=dtype,
                                                     device=dev)
            opt = FIX6_OPTIONS
        nC = cands.shape[1]
        data = type(data)(*[f.repeat_interleave(nC, dim=0) for f in data])
        z0 = init_vars(spec, data, x_init=cands.reshape((-1,) + cands.shape[2:]))
        solve = make_obca_solver(spec, opt, impl="plain")
    old = solve.iterate(solve.init(data, z0), data, 3)
    new = solve.step(old, data)
    g = torch.Generator(dev).manual_seed(seed)
    active = torch.rand(old.zv.shape[0], device=dev, generator=g) < 0.6
    active[0], active[-1] = True, False
    return old, new, active


PASS_THROUGH = ("sf", "scE", "scD")   # the IPMState fields the Newton body passes through


def check_freeze(dev):
    """ipm_freeze against the plain freeze (solver/loop.py freeze_plain),
    bit for bit (the state, the next active flags and the loop flag), at
    the fix step's, the runner's and the N = 74 open loop's shapes in both
    dtypes, with the body's pass-through fields (sf, scE, scD) aliasing
    the buffers they are written into, as the Newton loop passes them; the
    outputs' SHA-1s logged (to hold two checkouts' kernels to the same
    bits), the copy plan (kernels.freeze_launch_plan) and the device work
    of 20 calls replayed in a CUDA graph (a profiler window): the freeze
    kernel and nothing else, no memset. Times and bound (float32,
    every lane active) at the runner's 5 lanes (the main path's, phase 11;
    the kernels line's row), the fix step's 1280 and the N = 74 open
    loop's 5 lanes: aliased as the loop runs it (``ms``; the bound counts
    the fields it copies) and with every field copied (``ms_all``,
    ``bound_ms_all``). ``ms`` and ``plain_ms`` are device times inside a
    captured graph, as the loop runs them (``graph_ms``); ``wrapper_ms`` is
    an eager call, bound by the wrapper's host work."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    row, shapes = None, {}
    for kind in ("fix", "runner5", "runner2", "N74"):
        for dtype in (torch.float64, torch.float32):
            tag = f"{kind} {'f64' if dtype == torch.float64 else 'f32'}"
            old, new, active = _freeze_inputs(kind, dtype, dev, seed=len(tag))
            B = active.shape[0]
            sha = {}
            for cap in (4, 100):
                cap_t = torch.tensor([cap], dtype=torch.int32, device=dev)
                pst, pnext, pflag = loop.freeze_plain(new, old, active, cap_t)
                kst = type(old)(*[f.clone() for f in old])
                knew = new._replace(**{f: getattr(kst, f) for f in PASS_THROUGH})
                kact = active.clone()
                flag = torch.full((1,), 7, dtype=torch.int32, device=dev)
                n0 = kernels.launches["ipm_freeze"]
                kernels.ipm_freeze(knew, kst, kact, cap_t, flag)
                torch.cuda.synchronize()
                check(kernels.launches["ipm_freeze"] == n0 + 1, f"ipm_freeze {tag}: not launched")
                for name, a, b in zip(old._fields, kst, pst):
                    check(torch.equal(a, b), f"ipm_freeze {tag} cap {cap}: field {name} differs")
                check(torch.equal(kact, pnext) and torch.equal(flag, pflag),
                      f"ipm_freeze {tag} cap {cap}: active flags or loop flag differ")
                sha[cap] = sha1(torch.cat([_bytes_of(t) for t in (*kst, kact, flag)]))
            # the device work of 20 calls replayed in a CUDA graph: the
            # freeze kernel and no memset (the profiler may miss a few of
            # the 20 kernels at its window's start)
            work = _graph_work(lambda: kernels.ipm_freeze(knew, kst, kact, cap_t, flag), 20)
            check(work is None or (set(work) == {"ipm_freeze_kernel"}
                                   and work["ipm_freeze_kernel"] <= 20),
                  f"ipm_freeze {tag}: the freeze kernel alone expected, got {work}")
            ints = kernels._freeze_ints(kernels._DTYPE_CODE[dtype], B, old, [
                kernels.freeze_field_mode(n, o) for n, o in zip(knew, kst)])
            info = {"lanes": B, "active": int(active.sum()), "state_bytes": nbytes(*old),
                    "bit_equal": True, "sha1": sha,
                    "plan": kernels.freeze_launch_plan(ints)._asdict(), "graph_work": work}
            if dtype == torch.float32 and kind != "runner2":
                # every lane active and staying active: the same work per call
                new_t = new._replace(done=torch.zeros_like(new.done))
                kst = type(old)(*[f.clone() for f in old])
                act = torch.ones(B, dtype=torch.bool, device=dev)
                cap_t = torch.tensor([10 ** 6], dtype=torch.int32, device=dev)
                flag = torch.zeros(1, dtype=torch.int32, device=dev)
                as_loop = new_t._replace(**{f: getattr(kst, f) for f in PASS_THROUGH})
                run = lambda: kernels.ipm_freeze(as_loop, kst, act, cap_t, flag)
                run_all = lambda: kernels.ipm_freeze(new_t, kst, act, cap_t, flag)
                info["ms"] = graph_ms(run)
                info["ms_all"] = graph_ms(run_all)
                info["wrapper_ms"] = time_ms(run)
                info["plain_ms"] = graph_ms(lambda: loop.freeze_plain(new_t, kst, act, cap_t))
                info["plain_eager_ms"] = time_ms(
                    lambda: loop.freeze_plain(new_t, kst, act, cap_t), reps=5, warm=1)
                info["library_ms"] = None
                # the new state read and the old state written (every lane
                # active; aliased fields are not moved), the active flags
                # read and written, cap and flag
                moved = [o for n, o in zip(as_loop, kst) if n.data_ptr() != o.data_ptr()]
                info["bound_ms"], info["bound_by"] = bound(2 * nbytes(*moved) + 2 * B + 8, 0,
                                                           dtype)
                info["bound_ms_all"] = bound(2 * nbytes(*old) + 2 * B + 8, 0, dtype)[0]
                shapes[kind] = {k: info[k] for k in ("lanes", "ms", "ms_all", "plain_ms",
                                                     "bound_ms", "bound_ms_all", "bound_by")}
                if kind == "runner5":
                    row = dict(info, abs=0.0, rel=0.0)
            log(f"[kernels] ipm_freeze {tag}: " + json.dumps(info))
    return {"ipm_freeze": row, "ipm_freeze shapes": shapes}


def _graph_work(fn, n):
    """The device work of ``n`` calls of ``fn`` captured in one CUDA graph
    and replayed once under torch.profiler: kernel launches by name (the
    name's text before its template or argument list, the kernel's own
    name) and memsets ("memset"); None where the profiler saw no device
    work."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
    finally:
        if gc_on:
            gc.enable()
    g.replay()
    torch.cuda.synchronize()
    top = _profile_window(g.replay)["top"]
    if not top:
        return None
    work = {}
    for e in top:
        name = e["name"]
        key = "memset" if "emset" in name else name.split("(")[0].split("<")[0].split()[-1]
        work[key] = work.get(key, 0) + e["count"]
    return work


def _bytes_of(t):
    import torch

    return t.contiguous().view(-1).view(torch.uint8)


def phase_kernels(dev):
    """Phase 3; returns the timed rows at the fix_terminal float32 shapes
    (the main path's; spd_inv_blocked's at the N = 74 float32 shape) and
    logs every configuration."""
    import torch

    report = {}
    configs = [("free", torch.float64, 1, False), ("free", torch.float64, 2, False),
               ("free", torch.float32, 1, True),
               ("fix_terminal", torch.float64, 2, False),
               ("fix_terminal", torch.float32, 2, True),
               ("fix_free_end", torch.float64, 2, False),
               ("fix_free_end", torch.float32, 2, False)]
    # the rollout's own shapes: the sweep's free rung and the N = 15 demo
    configs += [(kind, dtype, 2, False)
                for kind in ("sweep free", "demo8 free", "demo8 fix_terminal",
                             "demo8 fix_free_end")
                for dtype in (torch.float64, torch.float32)]
    # the open loop's: N = 74 free time (timed), N = 50 fix_terminal
    configs += [("open74 free", torch.float64, 2, True), ("open74 free", torch.float32, 2, True),
                ("open50 fix_terminal", torch.float64, 2, False),
                ("open50 fix_terminal", torch.float32, 2, False)]
    # the variants fix_eq_band and coupled motion at the fix step's width
    configs += [(kind, dtype, 2, dtype == torch.float32) for kind in VARIANT_STAGES
                for dtype in (torch.float64, torch.float32)]
    for kind, dtype, R, timing in configs:
        tag = f"{kind} {'f64' if dtype == torch.float64 else 'f32'} R={R}"
        t0 = time.time()
        x = _stage_inputs(kind, dtype, dev, R)
        rows = check_kernels(x, tag, timing)
        log(f"[kernels] {tag} lanes={x['st'].zv.shape[0]} ({time.time() - t0:.1f} s): "
            + json.dumps(rows, default=float))
        if kind == "fix_terminal" and timing:
            report.update(rows)
        if kind == "sweep free" and dtype == torch.float32:   # the AL solve's time here too
            from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
            al_fn = lambda: kernels.newton_al_solve(*_al_args(x))
            rows["newton_al_solve"].update(ms=time_ms(al_fn), graph_ms=graph_ms(al_fn, reps=3))
            ls_args = _ls_lanes(x, torch.arange(x["st"].zv.shape[0], device=dev))[0]
            ls_fn = lambda: kernels.step_linesearch(*ls_args)
            rows["step_linesearch"].update(ms=time_ms(ls_fn), graph_ms=graph_ms(ls_fn, reps=3))
            rows["step_linesearch"]["trials"] = _ls_trials(x)
        # the provider at every main path's shape, N = 74 also in float64, and
        # at the host driver's 2 and 5 lanes (N = 6 and N = 15)
        lb = {"free": "free", "fix_terminal": "fix", "sweep free": "sweep", "open74 free": "N74",
              "demo8 fix_terminal": "host N=15"}.get(kind)
        if lb and (dtype == torch.float32 or kind == "open74 free"):
            ps = report.setdefault("obca_kkt_provider shapes", {})
            if lb != "host N=15":
                ps[lb if dtype == torch.float32 else lb + " f64"] = _provider_shape(x)
            if kind in ("fix_terminal", "demo8 fix_terminal"):
                for lanes in (2, 5):
                    ps[f"host N={x['spec'].N} lanes={lanes}"] = _provider_shape(x, lanes)
        if lb and (dtype == torch.float32 or kind == "open74 free"):
            ss = report.setdefault("newton_schur shapes", {})
            if lb != "host N=15":
                ss[lb if dtype == torch.float32 else lb + " f64"] = _schur_shape(x)
            if kind in ("fix_terminal", "demo8 fix_terminal"):
                for lanes in (2, 5):
                    ss[f"host N={x['spec'].N} lanes={lanes}"] = _schur_shape(x, lanes)
        lb = {"free": "free", "fix_terminal": "fix", "sweep free": "sweep",
              "open74 free": "N74"}.get(kind)
        if lb and "ms" in rows["newton_al_solve"] and dtype == torch.float32:
            # every main path's shape
            report.setdefault("newton_al_solve shapes", {})[lb] = rows["newton_al_solve"]
        if lb and "ms" in rows["step_linesearch"]:   # every main path's shape, N = 74 also in float64
            report.setdefault("step_linesearch shapes", {})[
                lb if dtype == torch.float32 else lb + " f64"] = rows["step_linesearch"]
        if kind == "open74 free" and dtype == torch.float32:
            report["spd_inv_blocked"] = rows["spd_inv_blocked"]
            report["newton_assemble N74"] = rows["newton_assemble"]
        if kind in VARIANT_STAGES and timing:   # the variants' times, under "variants"
            for name, r in rows.items():
                report.setdefault("variants", {}).setdefault(name, {})[kind] = {
                    k: r[k] for k in ("abs", "rel", "graph_ms", *TIME_KEYS) if k in r}
        del x
        torch.cuda.empty_cache()
    check_spd_alone(dev)
    report.update(check_astar(dev))
    report.update(check_freeze(dev))
    return report


def phase_variants(dev, reps=3):
    """Phase 12: the fix_eq_band and coupled-motion batches (256 fixture
    rows: 1280 and 512 lanes) as multistarts through make_obca_solver's
    graphed loop and the kernels, float32: solves/s (median of ``reps``
    after a counted warm-up), the slowest lane's iterations and the
    feasible fraction beside the plain host loop's on the card (at most
    0.02 below it); then float64 against the plain host loop: feasibility
    equal on >= 99% of rows, iterations equal on >= 99%, the picked z
    within 1e-6 on every row of equal iterations, feasible or not.
    Returns the launch counts of the kernel path's counted float32
    runs."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
        make_multistart_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    t_phase = time.perf_counter()
    total = {k: 0 for k in kernels.launches}
    for name in VARIANT_BATCHES:
        out = {}
        for dtype in (torch.float32, torch.float64):
            spec, data, cands, opt, nC = _variant_batch(name, dtype, dev)
            B = data.x0.shape[0]
            res = {}
            for label, impl, loop in (("kernels", None, "graph"), ("plain", "plain", "host")):
                ms = make_multistart_solver(
                    spec, make_obca_solver(spec, opt, impl=impl, loop=loop), init_vars, nC)
                kernels.reset_launch_counts()
                _, (r, _) = _timed_runs(lambda: ms(data, cands), 1)   # warm-up, counted
                counts = dict(kernels.launches)
                stats = {"feasible_fraction": float(r.feas.float().mean()),
                         "iters_slowest_lane": ms.last["iters"]}
                if dtype == torch.float32:
                    times, _ = _timed_runs(lambda: ms(data, cands), reps if impl is None else 1)
                    stats.update(solves_per_s=B / statistics.median(times), seconds=times)
                if impl is None:
                    check(all(counts[k] > 0 for k in FUSED),
                          f"variants {name}: a kernel was not launched: {counts}")
                    if dtype == torch.float32:
                        for k in total:
                            total[k] += counts[k]
                else:
                    check(all(v == 0 for v in counts.values()),
                          f"variants {name}: the plain run launched a kernel")
                res[label] = (r, stats, counts)
            (rk, sk, ck), (rp, sp, _) = res["kernels"], res["plain"]
            tag = "f32" if dtype == torch.float32 else "f64"
            row = {"rows": B, "lanes": B * nC, "kernels": sk, "plain": sp,
                   "launches": {k: ck[k] for k in FUSED + ("ipm_freeze",)}}
            if dtype == torch.float32:
                check(sk["feasible_fraction"] >= sp["feasible_fraction"] - 0.02,
                      f"variants {name} f32: feasible fraction {sk['feasible_fraction']:.4f} "
                      f"more than 0.02 below the plain loop's {sp['feasible_fraction']:.4f}")
            else:
                agree = float((rk.feas == rp.feas).float().mean())
                same = rk.iters == rp.iters
                both = same & rk.feas & rp.feas

                def dz(rows):   # equal entries (NaN on both sides too) agree; NaN fails
                    if not bool(rows.any()):
                        return 0.0
                    d = [torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())
                         [rows].max().item() for a, b in ((rk.z[k], rp.z[k]) for k in rk.z)]
                    return float("nan") if any(v != v for v in d) else max(d)

                row.update(feas_agree=agree, same_iters=float(same.float().mean()),
                           rows_compared=int(same.sum()), max_abs_dz=dz(same),
                           rows_feasible=int(both.sum()), max_abs_dz_feasible=dz(both))
                check(agree >= 0.99, f"variants {name} f64: feasibility agrees on {agree:.4f} "
                                     "of rows < 0.99")
                check(row["same_iters"] >= 0.99, f"variants {name} f64: iterations agree on "
                                                 f"{row['same_iters']:.4f} of rows < 0.99")
                check(row["max_abs_dz"] <= 1e-6, f"variants {name} f64: picked z differs by "
                                                 f"{row['max_abs_dz']:.3e} > 1e-6 on a row of "
                                                 "equal iterations")
            out[tag] = row
            log(f"[variants] {name} {tag}: " + json.dumps(row))
            del data, cands, res, rk, rp
            torch.cuda.empty_cache()
    log(f"[variants] phase 12 {time.perf_counter() - t_phase:.1f} s")
    return total


def serpentine_grid(n=21):
    """An n x n maze (1.0 = blocked) as nested lists: walls on every odd
    row, each open at one end, the ends alternating, so that the corridor
    from row 0 to row n - 1 is ~n^2 / 2 moves, longer than the default cap
    of 2 (R + C) relaxations."""
    g = [[0.0] * n for _ in range(n)]
    for k, y in enumerate(range(1, n - 1, 2)):
        gap = n - 1 if k % 2 == 0 else 0
        g[y] = [0.0 if x == gap else 1.0 for x in range(n)]
    return g


ASTAR_TIMED = ("sweep 1024x11x40", "demo9 (61, 41)", "demo10 (11, 100)")


def _astar_grids(dtype, dev):
    """(label, grid, start_yx, goal_yx, max_iters or None for the default)
    of phase 3's A* cases: the sweep's 1024 maps (the warp route), at caps
    0, 1 and 7 too, and its first 2 maps (the CTA route); the demo9 and
    demo10 grids (a CTA a map) and demo9's tiled over 1024 maps with goals
    and starts spread over its free cells (the warp route at a tall grid);
    an all-free 11 x 40 grid, goals in its corners, every cell a start
    (many equal candidates: the walk's tie-break), and the serpentine maze
    of serpentine_grid, every cell a start (the default cap binds), each
    on both routes (all maps, and the first 8 or 4)."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario, get_demo, random_scenarios)

    cell = lambda pose: pose[:, [1, 0]].to(torch.int32)
    i32 = lambda t: torch.as_tensor(t, dtype=torch.int32, device=dev)
    scn, _ = random_scenarios(0, 1024, dtype=dtype, device=dev)
    g, st, go = scn.grid, cell(scn.start), cell(scn.goal)
    out = [("sweep 1024x11x40", g, st, go, None)]
    out += [(f"sweep 1024x11x40 cap {c}", g, st, go, c) for c in (0, 1, 7)]
    out.append(("sweep first 2", g[:2].contiguous(), st[:2].contiguous(), go[:2].contiguous(),
                None))
    for name in ("demo9", "demo10"):
        s, _ = build_scenario(get_demo(name), dtype=dtype, device=dev)
        out.append((f"{name} {tuple(s.grid.shape)}", s.grid[None], cell(s.start[None]),
                    cell(s.goal[None]), None))
        if name == "demo9":
            free = (s.grid < 0.5).nonzero().to(torch.int32)
            k = torch.arange(1024, device=dev)
            out.append(("demo9 x1024", s.grid[None].repeat(1024, 1, 1),
                        free[(k * 104729 + 13) % len(free)].contiguous(),
                        free[(k * 7919) % len(free)].contiguous(), None))
    yx = torch.stack(torch.meshgrid(torch.arange(11), torch.arange(40), indexing="ij"), -1)
    starts = i32(yx.reshape(-1, 2))
    corners = i32([[0, 0], [0, 39], [10, 0], [10, 39]])[torch.arange(440) % 4]
    og = torch.zeros(440, 11, 40, dtype=dtype, device=dev)
    few = torch.arange(8) * 55   # 8 of them, spread
    out += [("open 440", og, starts, corners, None),
            ("open 8", og[:8].contiguous(), starts[few].contiguous(), corners[few].contiguous(),
             None)]
    maze = torch.tensor(serpentine_grid(), dtype=dtype, device=dev)
    n = maze.shape[0]
    yx = torch.stack(torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij"), -1)
    starts, goals = i32(yx.reshape(-1, 2)), i32([[0, 0]] * n * n)
    mg = maze[None].repeat(n * n, 1, 1)
    out += [(f"serpentine {n * n}", mg, starts, goals, None),
            ("serpentine 4", mg[:4].contiguous(), starts[-4:].contiguous(),
             goals[:4].contiguous(), None)]
    return out


def _astar_large_walk(dtype, dev):
    """(field, start_yx) of 2 maps whose field is too large to stage in
    shared memory (200 x 190 in float64, 260 x 240 in float32: the walk
    reads device memory), 40 relaxations of random obstacles, a block of
    NaN cells planted in the second."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar

    R, C = (200, 190) if dtype == torch.float64 else (260, 240)
    gen = torch.Generator().manual_seed(3)
    grid = (torch.rand(2, R, C, generator=gen, dtype=torch.float64) < 0.2).to(dev, dtype)
    goal = torch.tensor([[5, 7], [150, 100]], dtype=torch.int32, device=dev)
    field = astar.cost_to_go_plain(grid, goal, 40)[0]
    field[1, 110:130, 50:70] = float("nan")
    return field, torch.tensor([[20, 30], [120, 60]], dtype=torch.int32, device=dev)


def check_astar(dev):
    """astar_cost_to_go and astar_extract_path against their plain
    versions, bit for bit, at every case of _astar_grids in both dtypes,
    each with its route (kernels.astar_route / astar_walk, which must
    equal the library's); both routes of astar_cost_to_go must run; the
    walk of a field too large to stage (_astar_large_walk). Times
    and bounds at the sweep's float32 shape (the main path's: the kernels
    line's row) and at the demo9 and demo10 single maps (its "shapes").
    Returns the report rows."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        SWEEP_PATH_LEN)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar

    rows, shapes, routes = {}, {k: {} for k in ASTAR}, set()
    L = SWEEP_PATH_LEN
    for dtype in (torch.float64, torch.float32):
        for label, grid, start, goal, cap in _astar_grids(dtype, dev):
            tag = f"{label} {'f64' if dtype == torch.float64 else 'f32'}"
            B, R, C = grid.shape
            route, walk = kernels.astar_route(B, R, C, dtype), kernels.astar_walk(B, R, C, dtype)
            check((route, walk) == kernels.astar_route_of_library(B, R, C, dtype),
                  f"astar {tag}: kernels.astar_route / astar_walk differ from the library's")
            routes.add(route.route)
            it = astar.default_max_iters(grid) if cap is None else cap
            d, relax = kernels.astar_cost_to_go(grid, goal, it)
            dp, relax_p = astar.cost_to_go_plain(grid, goal, it)
            path, valid = kernels.astar_extract_path(dp, start, L)
            pp, vp = astar.extract_path_plain(dp, start, L)
            torch.cuda.synchronize()
            check(torch.equal(d, dp), f"astar_cost_to_go {tag}: field differs from plain "
                  f"({int((d != dp).sum())} cells)")
            check(torch.equal(relax, relax_p), f"astar_cost_to_go {tag}: relaxations differ")
            check(torch.equal(path, pp) and torch.equal(valid, vp),
                  f"astar_extract_path {tag}: path differs from plain")
            log(f"[kernels] astar {tag}: field, relaxations, path and valid equal to plain; "
                f"route {route.route} ({route.per_cta} a CTA, seg_h {route.seg_h}), walk "
                f"{walk.per_cta} a CTA {'staged' if walk.smem else 'in device memory'}; "
                f"relaxations median {float(relax.float().median()):.0f} max "
                f"{int(relax.max())} (cap {it + 1}); valid length median "
                f"{float(valid.sum(1).float().median()):.0f}")
            if not (label in ASTAR_TIMED and dtype == torch.float32):
                continue
            n_relax = int(relax.sum())
            c_row = {"route": route.route, "relaxations": n_relax,
                     "ms": time_ms(lambda: kernels.astar_cost_to_go(grid, goal, it)),
                     "graph_ms": graph_ms(lambda: kernels.astar_cost_to_go(grid, goal, it),
                                          n=20, reps=3)}
            # per relaxation every cell takes 8 neighbour adds and 8 minima
            c_row["bound_ms"], c_row["bound_by"] = bound(
                nbytes(grid, goal, d, relax), n_relax * R * C * 8 * 2, dtype)
            p_row = {"ms": time_ms(lambda: kernels.astar_extract_path(dp, start, L)),
                     "graph_ms": graph_ms(lambda: kernels.astar_extract_path(dp, start, L),
                                          n=20, reps=3)}
            # the field read once at most; 8 comparisons per move
            p_row["bound_ms"], p_row["bound_by"] = bound(nbytes(dp, start, path, valid),
                                                         B * L * 8, dtype)
            shapes["astar_cost_to_go"][label] = c_row
            shapes["astar_extract_path"][label] = p_row
            if label.startswith("sweep"):
                rows["astar_cost_to_go"] = dict(
                    c_row, abs=0.0, rel=0.0, library_ms=None,
                    plain_ms=time_ms(lambda: astar.cost_to_go_plain(grid, goal, it),
                                     reps=5, warm=1))
                rows["astar_extract_path"] = dict(
                    p_row, abs=0.0, rel=0.0, library_ms=None,
                    plain_ms=time_ms(lambda: astar.extract_path_plain(dp, start, L),
                                     reps=5, warm=1))
            log(f"[kernels] astar {tag} timing: " + json.dumps(
                {k: shapes[k][label] for k in ASTAR}))
    check(routes == {"warp", "cta"}, f"astar_cost_to_go: routes run {sorted(routes)}, "
          "expected both")
    for dtype in (torch.float64, torch.float32):
        field, start = _astar_large_walk(dtype, dev)
        check(kernels.astar_walk(*field.shape, dtype).smem == 0,
              "astar_extract_path: the large field is staged")
        path, valid = kernels.astar_extract_path(field, start, L)
        pp, vp = astar.extract_path_plain(field, start, L)
        check(torch.equal(path, pp) and torch.equal(valid, vp),
              f"astar_extract_path {tuple(field.shape)} {dtype}: the walk in device memory "
              "differs from plain")
        log(f"[kernels] astar walk in device memory {tuple(field.shape)} {dtype}: path and "
            "valid equal to plain")
    rows.update({f"{k} shapes": shapes[k] for k in ASTAR})
    return rows


def phase_entry(dev):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        ENTRY_OPTIONS, demo1_problem)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    spec, data, _, _ = demo1_problem(torch.float64, "cpu")
    r_cpu = make_obca_solver(spec, ENTRY_OPTIONS)(data)
    out = {}
    for dtype in (torch.float64, torch.float32):
        spec, data, _, _ = demo1_problem(dtype, dev)
        solve = make_obca_solver(spec, ENTRY_OPTIONS)
        kernels.reset_launch_counts()
        r = solve(data)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        check(all(counts[k] > 0 for k in FUSED), f"entry {dtype}: launch counts {counts}")
        log(f"[entry] {dtype}: iters {int(r.iters[0])} feas {bool(r.feas[0])} "
            f"kkt_err {float(r.kkt_err[0]):.4e} viol {float(r.viol[0]):.4e} "
            f"T {float(r.z['T'][0]):.6f} launches {counts}")
        out[str(dtype)] = r
    r64 = out[str(torch.float64)]
    dz = max((r64.z[k].cpu() - r_cpu.z[k]).abs().max().item() for k in r_cpu.z)
    log(f"[entry] CPU plain float64: iters {int(r_cpu.iters[0])} feas "
        f"{bool(r_cpu.feas[0])}; card float64 vs CPU: max |dz| {dz:.3e}")
    check(int(r64.iters[0]) == int(r_cpu.iters[0]), "entry: float64 iters differ from CPU")
    check(dz <= 1e-6, f"entry: float64 z differs from CPU by {dz:.3e}")
    check(bool(r64.feas[0]), "entry: float64 solve not feasible")


def _iter_stats(it):
    it = sorted(it)
    if not it:
        return {"n": 0}
    return {"n": len(it), "median": float(statistics.median(it)),
            "p90": float(it[int(0.9 * (len(it) - 1))]), "max": int(it[-1])}


def _batch_stats(r, B):
    it = r.iters.cpu().numpy()
    return {"feasible_fraction": float(r.feas.float().mean()),
            "iters_median": float(statistics.median(it.tolist())),
            "iters_p90": float(sorted(it.tolist())[int(0.9 * (B - 1))]),
            "iters_max": int(it.max()),
            "dispatched_lane_iters": int(it.max()) * B,
            "useful_lane_iters": int(it.sum())}


def _timed_runs(fn, reps):
    import torch

    times = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out


def phase_batch(dev, reps=3):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    B = 256
    spec, data, _, _ = demo9_window_batch(B, dtype=torch.float32, device=dev)
    results = {}
    for label, impl in (("kernels", None), ("plain", "plain")):
        solve = make_obca_solver(spec, BENCH_FREE_OPTIONS, impl=impl)
        kernels.reset_launch_counts()
        r = solve(data)                       # warm-up, and the counted run
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        stats = _batch_stats(r, B)
        times, r2 = _timed_runs(lambda: solve(data), reps)
        t = statistics.median(times)
        rerun = max((r2.z[k] - r.z[k]).abs().max().item() for k in r.z)
        stats.update(solves_per_s=B / t, seconds=times, rerun_max_abs_dz=rerun)
        log(f"[batch] {label}: " + json.dumps(stats) + f" launches {counts}")
        results[label] = (stats, counts, r2)
    stats_k, counts_k, rk = results["kernels"]
    check(stats_k["feasible_fraction"] >= 0.99,
          f"batch: kernel feasible fraction {stats_k['feasible_fraction']:.4f} < 0.99")
    check(all(counts_k[k] > 0 for k in FUSED), f"batch: launch counts {counts_k}")
    check(all(v == 0 for v in results["plain"][1].values()),
          "batch: the plain run launched a kernel")
    rp = results["plain"][2]
    same = float((rk.iters == rp.iters).float().mean())
    dz = max((rk.z[k] - rp.z[k]).abs().max().item() for k in rk.z)
    log(f"[batch] kernels vs plain (float32): same iters on {same:.4f} of lanes, "
        f"max |dz| {dz:.3e}")
    return counts_k


RUNG_NAMES = ("mpc6", "mpc8", "qr6", "qr8")


def _fix_stats(res, rungs):
    B = res.feas.shape[0]
    seen = None
    per = {}
    for name, r in zip(RUNG_NAMES, rungs):
        it = r.iters.cpu().tolist()
        ran = [i for i in it if i > 0]
        newly = r.feas if seen is None else (r.feas & ~seen)
        seen = r.feas.clone() if seen is None else (seen | r.feas)
        per[name] = {"rows_run": len(ran), "made_feasible": int(newly.sum()),
                     "iters": _iter_stats(ran)}
    return {"rows": B, "feasible_fraction": float(res.feas.float().mean()),
            "iters_total": _iter_stats(res.iters.cpu().tolist()), "rungs": per}


def phase_fixstep(dev, reps=5):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        fix_fixture_batch, make_fix_step)

    spec6, spec8, data, cands = fix_fixture_batch(256, dtype=torch.float32, device=dev)
    B = data.x0.shape[0]
    results = {}
    for label, impl, n in (("kernels", None, reps), ("plain", "plain", 0)):
        step = make_fix_step(spec6, spec8, qr_rescue=True, impl=impl)
        kernels.reset_launch_counts()
        times, (res, rungs) = _timed_runs(lambda: step(data, cands), 1)   # counted
        counts = dict(kernels.launches)
        stats = _fix_stats(res, rungs)
        if n:
            more, (res2, _) = _timed_runs(lambda: step(data, cands), n)
            stats["rerun_max_abs_dz"] = max((res2.z[k] - res.z[k]).abs().max().item()
                                            for k in res.z)
            times = more
        stats.update(steps_per_s=B / statistics.median(times), seconds=times)
        log(f"[fixstep] {label}: " + json.dumps(stats) + f" launches {counts}")
        results[label] = (stats, counts, res)
    stats_k, counts_k, rk = results["kernels"]
    check(stats_k["feasible_fraction"] >= 0.99,
          f"fixstep: ladder feasible fraction {stats_k['feasible_fraction']:.4f} < 0.99")
    check(all(counts_k[k] > 0 for k in FUSED), f"fixstep: launch counts {counts_k}")
    check(all(v == 0 for v in results["plain"][1].values()),
          "fixstep: the plain run launched a kernel")
    rp = results["plain"][2]
    same = float((rk.iters == rp.iters).float().mean())
    log(f"[fixstep] kernels vs plain (float32): same total iters on {same:.4f} of rows, "
        f"plain feasible {results['plain'][0]['feasible_fraction']:.4f}")
    return counts_k


def phase_qr(dev):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        FIX8_OPTIONS, N_CAND_FIX, fix_fixture_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
        make_multistart_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    opt = dataclasses.replace(FIX8_OPTIONS, kkt="qr")

    def msolve(dtype, device, rows):
        spec6, _, data, cands = fix_fixture_batch(dtype=dtype, device=device, rows=rows)
        ms = make_multistart_solver(spec6, make_obca_solver(spec6, opt), init_vars,
                                    N_CAND_FIX)
        return lambda: ms(data, cands)

    run = msolve(torch.float32, dev, list(range(32)))
    kernels.reset_launch_counts()
    times, (r, best) = _timed_runs(run, 1)
    counts = dict(kernels.launches)
    stats = {"rows": 32, "lanes": 32 * N_CAND_FIX,
             "feasible_fraction": float(r.feas.float().mean()),
             "iters": _iter_stats(r.iters.cpu().tolist()), "seconds": times}
    log(f"[qr] float32 kkt='qr' fix_terminal multistart: " + json.dumps(stats)
        + f" launches {counts}")
    check(counts["kkt_qr"] > 0, f"qr: kkt_qr never launched {counts}")
    check(all(counts[k] > 0 for k in ("obca_kkt_provider", "newton_assemble",
                                       "step_linesearch")), f"qr: launch counts {counts}")

    r64, b64 = msolve(torch.float64, dev, [0, 1])()
    rcpu, bcpu = msolve(torch.float64, "cpu", [0, 1])()
    dz = max((r64.z[k].cpu() - rcpu.z[k]).abs().max().item() for k in rcpu.z)
    log(f"[qr] float64 rows 0, 1: card iters {r64.iters.tolist()} best {b64.tolist()} "
        f"feas {r64.feas.tolist()}; CPU plain iters {rcpu.iters.tolist()} best "
        f"{bcpu.tolist()} feas {rcpu.feas.tolist()}; max |dz| {dz:.3e}")
    check(r64.iters.tolist() == rcpu.iters.tolist(), "qr: float64 iters differ from CPU")
    check(dz <= 1e-6, f"qr: float64 z differs from CPU by {dz:.3e}")
    return counts


def _rung_profile(profile):
    """Per rung: steps it ran on, world-steps, the host-loop iterations of
    the steps it ran (median, max, sum) and its seconds over all steps
    (host clock, skipped steps' init and finalize included)."""
    out = {}
    for rung in profile[0]:
        ran = [st[rung] for st in profile if st[rung][0]]
        its = [i for _, i, _ in ran]
        out[rung] = {"steps": len(ran), "world_steps": sum(r for r, _, _ in ran),
                     "iters_median": float(statistics.median(its)) if its else 0.0,
                     "iters_max": max(its) if its else 0,
                     "iters_sum": sum(its),
                     "seconds": sum(st[rung][2] for st in profile)}
    return out


def phase_sweep(dev, B=1024, steps=30):
    """Phase 8: the random sweep at full width through the kernels, then a
    64-world, 3-step slice through the kernels and the plain versions."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        sweep_inputs, sweep_stats)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        make_scan_rollout)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        Scenario)

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    dtype = torch.float32
    kernels.reset_launch_counts()
    loop.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scn, shape, p, ref, ref_len = sweep_inputs(B, seed=0, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    t_inputs = time.perf_counter() - t0
    roll = make_scan_rollout(shape, p, max_steps=steps, dtype=dtype, qr_rescue=True,
                             device=dev)
    profile = []
    t0 = time.perf_counter()
    final, traj = roll(scn, ref, ref_len, profile=profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    stats = sweep_stats(scn, final, traj)
    stats.update(wall_s=wall, sweep_replans_per_s=stats["replans"] / wall,
                 fixtime_share=stats["fixtime_replans"] / max(stats["replans"], 1),
                 inputs_s=t_inputs, ref_len_median=float(ref_len.float().median()),
                 host_iters_per_step=sum(r["iters_sum"] for r in _rung_profile(profile).values())
                 / steps)
    SWEEP_RUN.update(scn=scn, shape=shape, p=p, ref=ref, ref_len=ref_len, final=final,
                     traj=traj, source="phase 8")
    log(f"[sweep] B={B} steps={steps} float32: " + json.dumps(stats))
    log(f"[sweep] rungs: " + json.dumps(_rung_profile(profile)))
    log(f"[sweep] launches {counts}")
    log(f"[sweep] graphs: {loop.stats['captures']} captures "
        f"({loop.stats.get('build_ms', 0.0):.1f} ms to build, "
        f"{loop.stats.get('instantiate_ms', 0.0):.1f} of them instantiating), "
        f"{loop.stats['replays']} counted iterations; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    check(bool(torch.isfinite(traj["x"]).all()), "sweep: non-finite state")
    check(stats["failed_frac"] <= 0.03, f"sweep: failed_frac {stats['failed_frac']:.4f} > 0.03")
    check(stats["mean_progress_frac"] >= 0.17,
          f"sweep: mean_progress_frac {stats['mean_progress_frac']:.4f} < 0.17")
    check(all(counts[k] > 0 for k in FUSED + ASTAR), f"sweep: launch counts {counts}")

    sub = Scenario(*[f[:64] for f in scn])
    times = {}
    for label, impl in (("kernels", None), ("plain", "plain")):
        r3 = make_scan_rollout(shape, p, max_steps=3, dtype=dtype, device=dev, impl=impl)
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin3, traj3 = r3(sub, ref[:64], ref_len[:64])
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        st3 = sweep_stats(sub, fin3, traj3)
        log(f"[sweep] 64 worlds x 3 steps, {label}: {times[label]:.3f} s " + json.dumps(st3))
        check(bool(traj3["feas"].all()), f"sweep: 64x3 {label} infeasible on some step")
        if impl == "plain":
            check(dict(kernels.launches) == before, "sweep: the plain run launched a kernel")
    return counts


def phase_demos(dev, steps=30):
    """Phase 9: the 11 demos in float32 through the kernels; demo1 and
    demo3 in float64 against their goldens."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        demo_rollout_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        make_scan_rollout)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        demo_names)

    kernels.reset_launch_counts()
    runs = [(n, torch.float32) for n in demo_names()] + [("demo1", torch.float64),
                                                         ("demo3", torch.float64)]
    for name, dtype in runs:
        g = np.load(os.path.join(HERE, "goldens", f"{name}.npz"))
        scn, shape, p, ref, ref_len = demo_rollout_inputs(name, dtype, dev)
        roll = make_scan_rollout(shape, p, max_steps=steps, dtype=dtype, device=dev)
        profile = []
        t0 = time.perf_counter()
        final, traj = roll(scn, ref, ref_len, profile=profile)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        goal = scn.goal[0, :2].double().cpu().numpy()
        d0 = float(np.linalg.norm(scn.start[0, :2].double().cpu().numpy() - goal))
        d_end = float(np.linalg.norm(final.x0[0, :2].double().cpu().numpy() - goal))
        d_gold = float(np.linalg.norm(g["x"][-1, :2] - goal))
        modes = traj["fixtime"][0].cpu().numpy()
        dx = float(np.abs(traj["x"][0].double().cpu().numpy() - g["x"][:steps]).max())
        its = sum(r["iters_sum"] for r in _rung_profile(profile).values())
        log(f"[demos] {name} {str(dtype)[6:]}: N={p.N_free} {wall:.2f} s, host iterations "
            f"{its}, fix-time steps {int(modes.sum())} (golden {int(g['fixtime'].sum())}), "
            f"d_end {d_end:.4f} golden {d_gold:.4f} d0 {d0:.2f}, max |x - golden| {dx:.3e}, "
            f"failed {bool(final.failed[0])}")
        check(not bool(final.failed[0]), f"demos: {name} {dtype} aborted")
        check(d_end <= d_gold + 0.2 * d0, f"demos: {name} {dtype} end {d_end:.3f} > golden "
              f"{d_gold:.3f} + 0.2 d0")
        if dtype == torch.float64:
            check(bool((modes == g["fixtime"][:steps]).all()),
                  f"demos: {name} float64 mode flags differ from the golden")
            check(dx <= 1e-6, f"demos: {name} float64 states differ from the golden by {dx:.3e}")
    counts = dict(kernels.launches)
    log(f"[demos] launches {counts}")
    check(all(counts[k] > 0 for k in FUSED), f"demos: launch counts {counts}")
    return counts


def _ego_corners(x, ego):
    """(..., 5, 2) ego corners and centre at poses x (..., 3)
    (tests/test_demos_e2e.py)."""
    import numpy as np

    off = (ego[0] + ego[2]) / 2 - ego[2]
    hl, hw = (ego[0] + ego[2]) / 2, ego[1]
    c, s = np.cos(x[..., 2]), np.sin(x[..., 2])
    mx, my = x[..., 0] + off * c, x[..., 1] + off * s
    return np.stack([np.stack([mx + dx * c - dy * s, my + dx * s + dy * c], axis=-1)
                     for dx, dy in ((hl, hw), (hl, -hw), (-hl, hw), (-hl, -hw), (0.0, 0.0))],
                    axis=-2)


def _check_plan(tag, demo, x, u, dt, defect_tol, goal=True):
    """tests/test_open_loop.py's properties of a plan x (3, N+1), u (2, N)
    at step ``dt``: forward-Euler defect, start (and goal) anchoring, no
    ego corner strictly inside a closed static obstacle. Returns the
    measured values."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import (
        unicycle_step)

    pred = unicycle_step(torch.as_tensor(x[:, :-1].T), torch.as_tensor(u.T), dt).numpy().T
    defect = float(np.abs(pred - x[:, 1:]).max())
    d_start = float(np.abs(x[:, 0] - np.asarray(demo.start)).max())
    d_goal = float(np.abs(x[:2, -1] - np.asarray(demo.goal[:2])).max())
    check(defect <= defect_tol, f"{tag}: dynamics defect {defect:.3e} > {defect_tol:g}")
    check(d_start <= 1e-6, f"{tag}: start off by {d_start:.3e}")
    if goal:
        check(d_goal <= 2e-2, f"{tag}: goal off by {d_goal:.3e}")
    corners = _ego_corners(x.T, demo.params.ego).reshape(-1, 2)
    for poly in demo.static_lobs:
        v = np.asarray(poly)
        if len(v) < 4:
            continue
        inside = np.ones(len(corners), bool)
        for a, b in zip(v[:-1], v[1:]):
            e = b - a
            inside &= ((corners[:, 0] - a[0]) * e[1] - (corners[:, 1] - a[1]) * e[0]) >= 2e-2
        check(not inside.any(), f"{tag}: an ego corner inside the obstacle {poly}")
    return {"defect": defect, "start": d_start, "goal": d_goal}


def _perturbed_runs(solve, data, cands, reps=3, warm=True):
    """bench.py's timing of the open-loop multistart: one warm call (unless
    ``warm`` is false), then ``reps`` calls with the candidates scaled by
    1 + 1e-6 (i + 1); returns (seconds of each, warm seconds or None, last
    result, pick, host iterations)."""
    warm_s = None
    if warm:
        warm_s = _timed_runs(lambda: solve(data, cands), 1)[0][0]
    times = []
    for i in range(reps):
        cp = cands * (1.0 + 1e-6 * (i + 1))
        t, (r, best) = _timed_runs(lambda: solve(data, cp), 1)
        times += t
    return times, warm_s, r, best, solve.last["iters"]


def _profile_window(fn):
    """torch.profiler around ``fn()`` (ending in a synchronize): wall and
    device busy seconds, the idle share, the host's CUDA launches (kernel
    and graph launches, copies, memsets) and the events with device time,
    the largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    ev = list(prof.key_averages())
    timed = sorted((e for e in ev if dev_us(e) > 0), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in timed) / 1e6
    launch = [e for e in ev if e.key.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                                                  "cudaMemcpy", "cudaMemset"))]
    # the host waiting on the device (the window's closing synchronize included)
    syncs = [e for e in ev if e.key in ("cudaStreamSynchronize", "cudaEventSynchronize",
                                        "cudaDeviceSynchronize")]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": (1.0 - busy / wall) if timed else None,
            "host_launches": sum(e.count for e in launch),
            "launch_calls": {e.key: e.count for e in launch},
            "host_syncs": sum(e.count for e in syncs),
            "top": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "count": e.count}
                    for e in timed[:12]]}


def _profile_iterations(spec, opt, data, cands, n=10, loop=None):
    """torch.profiler over up to ``n`` Newton iterations of the
    multistart's lanes, after 3 (``loop`` as in make_obca_solver): the
    window of ``_profile_window`` per iteration."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    nC = cands.shape[1]
    data_l = type(data)(*[f.repeat_interleave(nC, dim=0) for f in data])
    solve = make_obca_solver(spec, opt, loop=loop)
    st = solve.iterate(solve.init(data_l, init_vars(spec, data_l, x_init=cands[0])), data_l, 3)
    torch.cuda.synchronize()
    out = {}
    out.update(_profile_window(lambda: out.update(st=solve.iterate(st, data_l, 3 + n))))
    iters = max(int(out.pop("st").it.max()) - int(st.it.max()), 1)
    return dict(out, iterations=iters, ms_per_iteration=1e3 * out["wall_s"] / iters,
                host_launches_per_iteration=out["host_launches"] / iters,
                host_syncs_per_iteration=out["host_syncs"] / iters)


def _first_split(spec, opt, data, cands):
    """Kernels and plain versions stepped in lockstep from the same start:
    the first iteration where some lane's z parts by more than 1e-6
    (max-normalised) or the lanes' done flags differ, and the condition
    numbers of that lane's Schur complements S (every rung) at the common
    iterate before it; None when they never part."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    nC = cands.shape[1]
    data_l = type(data)(*[f.repeat_interleave(nC, dim=0) for f in data])
    z0 = init_vars(spec, data_l, x_init=cands[0])
    sk, sp = make_obca_solver(spec, opt), make_obca_solver(spec, opt, impl="plain")
    stk, stp = sk.init(data_l, z0), sp.init(data_l, z0)
    for it in range(opt.max_iters):
        prev = stp
        stk, stp = sk.iterate(stk, data_l, it + 1), sp.iterate(stp, data_l, it + 1)
        rel = (stk.zv - stp.zv).abs().amax(1) / stp.zv.abs().amax(1)
        if bool((rel > 1e-6).any()) or not torch.equal(stk.done, stp.done):
            lane = int(torch.argmax(rel))
            x = _stage_from("split", spec, data_l, opt, sp, prev, opt.n_deltas)
            cond = torch.linalg.cond(x["Smat"][lane].double()).tolist()
            return {"iteration": it + 1, "lane": lane, "rel_dz": rel.tolist(),
                    "cond_S": cond}
        if bool(stp.done.all()) and bool(stk.done.all()):
            return None
    return None


def phase_openloop(dev):
    """Phase 10: the open loop (see the module docstring)."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        horizon_inputs, make_openloop_solve, openloop_n74_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        Simulation, run_open_loop)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        get_demo)

    kernels.reset_launch_counts()
    t_phase = time.perf_counter()

    # (a) bench.py's openloop_N74_s, float32, through the kernels
    spec, data, cands, opt = openloop_n74_inputs(torch.float32, dev)
    solve = make_openloop_solve(spec, opt)
    times, warm, r, best, host_it = _perturbed_runs(solve, data, cands)
    a = {"openloop_N74_s": min(times), "seconds": times, "warm_s": warm,
         "iters": int(r.iters[0]), "host_iters": host_it, "best": int(best[0]),
         "feasible": bool(r.feas[0]), "kkt_err": float(r.kkt_err[0]),
         "T": float(r.z["T"][0]), "ms_per_host_iteration": 1e3 * min(times) / max(host_it, 1),
         "launches": dict(kernels.launches)}
    log("[open] (a) N=74 float32 kernels: " + json.dumps(a))
    check(a["feasible"], "open (a): N = 74 float32 infeasible")
    check(kernels.launches["spd_inv_blocked"] > 0, "open (a): spd_inv_blocked never launched")
    check(all(kernels.launches[k] > 0 for k in FUSED), f"open (a): launches {kernels.launches}")
    prof = _profile_iterations(spec, opt, data, cands)
    log("[open] (a) profile, 10 iterations at N=74 float32: " + json.dumps(prof))

    # (b) float64, kernels against plain on the card
    spec, data, cands, opt = openloop_n74_inputs(torch.float64, dev)
    out = {}
    for label, impl in (("kernels", None), ("plain", "plain")):
        before = dict(kernels.launches)
        t, (res, bst) = _timed_runs(lambda: make_openloop_solve(spec, opt, impl)(data, cands), 1)
        if impl == "plain":
            check(dict(kernels.launches) == before, "open (b): the plain run launched a kernel")
        out[label] = (res, int(bst[0]), t[0])
    (rk, bk, tk), (rp, bp, tp) = out["kernels"], out["plain"]
    dz = max((rk.z[k] - rp.z[k]).abs().max().item() for k in rk.z)
    fk, fp = float(rk.f[0]), float(rp.f[0])
    b = {"kernels": {"best": bk, "iters": int(rk.iters[0]), "feasible": bool(rk.feas[0]),
                     "f": fk, "seconds": tk},
         "plain": {"best": bp, "iters": int(rp.iters[0]), "feasible": bool(rp.feas[0]),
                   "f": fp, "seconds": tp},
         "max_abs_dz": dz, "f_rel": abs(fk - fp) / abs(fp)}
    same = bk == bp and b["kernels"]["iters"] == b["plain"]["iters"] and dz <= 1e-6
    if not same:
        b["split"] = _first_split(spec, opt, data, cands)
    log("[open] (b) N=74 float64 kernels vs plain: " + json.dumps(b))
    if not same:
        check(b["kernels"]["feasible"] and b["plain"]["feasible"],
              "open (b): kernels and plain parted and not both feasible")
        check(b["f_rel"] <= 1e-6, f"open (b): objectives differ by {b['f_rel']:.3e}")

    # (c) run_open_loop("demo9", N=50), float64
    t, (rc,) = _timed_runs(lambda: (run_open_loop("demo9", N=50, dtype=torch.float64,
                                                  device=dev),), 1)
    demo = get_demo("demo9")
    check(rc.free["feas"] and rc.fix is not None and rc.fix["feas"],
          "open (c): demo9 N = 50 infeasible")
    check(not rc.fix["fallback"], "open (c): demo9 N = 50 needed the fix_free_end fallback")
    c = {"seconds": t[0], "Ts_opt_free": rc.free["Ts_opt"], "iters_free": rc.free["iters"],
         "iters_fix": rc.fix["iters"],
         "free": _check_plan("open (c) free", demo, rc.free["x"], rc.free["u"],
                             rc.free["Ts_opt"], 1e-4),
         "fix": _check_plan("open (c) fix", demo, rc.fix["x"], rc.fix["u"], rc.fix["Ts_opt"],
                            1e-3, goal=False)}
    ts = np.asarray(demo.terminal_policy.resolve(np.asarray(demo.start)))
    xx = rc.fix["x"]
    check(xx[0, -1] >= ts[0, 0] - 1e-6 and ts[1, 0] - 1e-6 <= xx[1, -1] <= ts[1, 1] + 1e-6,
          f"open (c): x_N {xx[:2, -1].tolist()} outside the terminal set {ts.tolist()}")
    log("[open] (c) demo9 N=50 float64: " + json.dumps(c))

    # (d) run_open_loop("demo1", N=50, fix_phase=False), float64
    t, (rd,) = _timed_runs(lambda: (run_open_loop("demo1", N=50, dtype=torch.float64,
                                                  device=dev, fix_phase=False),), 1)
    demo = get_demo("demo1")
    check(rd.feas and rd.fix is None, "open (d): demo1 N = 50 free phase infeasible")
    p = demo.params
    check(bool(np.all(np.abs(rd.u[0]) <= p.v_max + 1e-6) and
               np.all(np.abs(rd.u[1]) <= p.w_max + 1e-6)), "open (d): input bounds")
    d = {"seconds": t[0], "Ts_opt": rd.Ts_opt, "iters": rd.free["iters"],
         "plan": _check_plan("open (d)", demo, rd.x, rd.u, rd.Ts_opt, 1e-4)}
    log("[open] (d) demo1 N=50 float64 free phase: " + json.dumps(d))

    # (e) bench.py's horizon table, float32
    horizon = {}
    for N in (6, 10, 20, 40, 74):
        spec, data, cands, opt = horizon_inputs(N, torch.float32, dev)
        # two perturbed calls and no warm one (bench.py times 3 after its
        # compile; the port compiles nothing, and the script keeps to half
        # its time limit)
        times, _, r, _, host_it = _perturbed_runs(make_openloop_solve(spec, opt), data,
                                                  cands, reps=2, warm=False)
        horizon[str(N)] = {"s_per_solve": min(times), "solves_per_s": 1.0 / min(times),
                           "seconds": times, "iters": int(r.iters[0]),
                           "host_iters": host_it, "feasible": bool(r.feas[0])}
        log(f"[open] (e) horizon N={N}: " + json.dumps(horizon[str(N)]))
    for N in (10, 20, 40, 74):
        check(horizon[str(N)]["feasible"], f"open (e): horizon N = {N} infeasible")

    # (f) calc_time, float64
    rep = Simulation(dtype=torch.float64, device=dev).calc_time("demo9", N=10)
    log(f"[open] (f) calc_time demo9 N=10: A* {rep.astar_s:.4f} s, open loop "
        f"{rep.open_loop_s:.3f} s, feasible {rep.open_loop_feas}")
    check(rep.open_loop_feas, "open (f): calc_time infeasible")

    counts = dict(kernels.launches)
    log(f"[open] phase 10 {time.perf_counter() - t_phase:.1f} s, launches {counts}")
    return counts


def _replan_stats(runner, res):
    """Per-run numbers from the runner's MetricsLogger and its steps:
    replan_ms p50/p99 (all steps and per branch), iterations, fix-time
    steps and fallbacks."""
    m = runner.metrics
    q = m.quantiles("replan_ms")
    it = m.series["iters"]
    out = {"steps": len(res.steps), "replan_ms_p50": q["p50"], "replan_ms_p99": q["p99"],
           "iters_sum": int(sum(it)), "iters_median": float(statistics.median(it)),
           "fixtime_steps": m.counters.get("fixtime_steps", 0),
           "fallbacks": m.counters.get("fallbacks", 0),
           "qr_rescues": m.counters.get("qr_rescues", 0)}
    for label, fix in (("free", False), ("fix", True)):
        ms = [st.solve_ms for st in res.steps if st.fixtime == fix]
        out[f"replan_ms_p50_{label}"] = float(statistics.median(ms)) if ms else None
    return out


def _profile_replan(runner, problem, n_cand, loop_mode):
    """torch.profiler over one fix-time replan (the recorded problem, its
    winning start as all ``n_cand`` candidates), after a warm call; then
    over its Newton loop alone (10 iterations after 3). Each window: wall
    and device busy seconds, the idle share and the host's CUDA launches
    per Newton iteration."""
    import torch

    spec = problem["spec"]
    _, msolve = runner._solver(spec.variant, spec.N, n_cand)
    x = torch.as_tensor(problem["x_init"], device=runner.device).to(runner.dtype)
    cands = x[None, None].expand(1, n_cand, *x.shape).contiguous()
    msolve(problem["data"], cands)
    torch.cuda.synchronize()
    rep = _profile_window(lambda: msolve(problem["data"], cands))
    iters = max(msolve.last["iters"], 1)
    rep.pop("top")
    rep.update(iterations=msolve.last["iters"], ms_per_iteration=1e3 * rep["wall_s"] / iters,
               host_launches_per_iteration=rep["host_launches"] / iters,
               host_syncs_per_iteration=rep["host_syncs"] / iters)
    it = _profile_iterations(spec, runner.opt, problem["data"], cands, loop=loop_mode)
    return {"replan": rep, "loop_only": it}


def phase_closed(dev, steps=30):
    """Phase 11: the host closed-loop driver (runtime/closed_loop.py)."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        ClosedLoopRunner)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        demo_names, get_demo)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    t_phase = time.perf_counter()

    def run(name, dtype, loop_mode=None, max_steps=steps, **kw):
        runner = ClosedLoopRunner(get_demo(name), dtype=dtype, max_steps=max_steps,
                                  device=dev, loop=loop_mode, **kw)
        t0 = time.perf_counter()
        res = runner.run()
        torch.cuda.synchronize()
        return runner, res, time.perf_counter() - t0

    # (a) the 11 demos in float32 through the graphed loop and the kernels:
    # the main path of ipm_freeze (the kernels line's launches)
    kernels.reset_launch_counts()
    loop.reset_stats()
    for name in demo_names():
        g = np.load(os.path.join(HERE, "goldens", f"{name}.npz"))
        runner, res, wall = run(name, torch.float32)
        demo = get_demo(name)
        goal = np.asarray(demo.goal[:2])
        d0 = float(np.linalg.norm(np.asarray(demo.start[:2]) - goal))
        d_end = float(np.linalg.norm(res.x_history[-1, :2] - goal))
        d_gold = float(np.linalg.norm(g["x"][-1, :2] - goal))
        st = dict(_replan_stats(runner, res), seconds=wall, d_end=d_end, d_golden=d_gold,
                  d0=d0, golden_fixtime_steps=int(g["fixtime"].sum()),
                  golden_fallbacks=int(g["fallback"].sum()))
        log(f"[closed] (a) {name} float32: " + json.dumps(st))
        check(not res.aborted_infeasible, f"closed (a): {name} aborted")
        check(np.isfinite(res.x_history).all(), f"closed (a): {name} non-finite state")
        check(d_end <= d_gold + 0.2 * d0,
              f"closed (a): {name} end {d_end:.3f} > golden {d_gold:.3f} + 0.2 d0")
    counts = dict(kernels.launches)
    log(f"[closed] (a) graphs {dict(loop.stats)} launches {counts}")
    check(all(counts[k] > 0 for k in FUSED + ("ipm_freeze",)), f"closed (a): launches {counts}")
    check(loop.stats["captures"] > 0 and loop.stats["replays"] > 0,
          f"closed (a): no graph replayed {loop.stats}")

    # (b) demo1 and demo3 in float64 against their goldens
    for name in ("demo1", "demo3"):
        g = np.load(os.path.join(HERE, "goldens", f"{name}.npz"))
        runner, res, wall = run(name, torch.float64)
        dx = float(np.abs(res.x_history - g["x"][:steps]).max())
        fix = [s.fixtime for s in res.steps]
        fb = [s.fallback for s in res.steps]
        log(f"[closed] (b) {name} float64: {wall:.2f} s, max |x - golden| {dx:.3e}, "
            + json.dumps(_replan_stats(runner, res)))
        check(len(res.steps) == steps, f"closed (b): {name} ran {len(res.steps)} steps")
        check(fix == g["fixtime"][:steps].tolist() and fb == g["fallback"][:steps].tolist(),
              f"closed (b): {name} mode or fallback flags differ from the golden")
        check(dx <= 1e-6, f"closed (b): {name} states differ from the golden by {dx:.3e}")

    # (c) demo3 through the graphed loop and through the host loop, both
    # with the kernels: the same iterations and bits
    for dtype in (torch.float64, torch.float32):
        out = {}
        for mode in ("graph", "host"):
            runner, res, wall = run("demo3", dtype, loop_mode=mode)
            out[mode] = res
            log(f"[closed] (c) demo3 {str(dtype)[6:]} {mode} loop: {wall:.2f} s "
                + json.dumps(_replan_stats(runner, res)))
        a, b = out["graph"], out["host"]
        same_it = [s.iters for s in a.steps] == [s.iters for s in b.steps]
        same_x = np.array_equal(a.x_history, b.x_history)
        log(f"[closed] (c) demo3 {str(dtype)[6:]}: iterations equal {same_it}, states "
            f"bit-equal {same_x}, max |dx| {float(np.abs(a.x_history - b.x_history).max()):.3e}")
        check(same_it and same_x, f"closed (c): demo3 {dtype} graph and host loops differ")

    # (d) the legacy drivers, demo1, 3 steps, float32
    for mode in ("mpc1", "mpc3"):
        runner = ClosedLoopRunner(get_demo("demo1"), dtype=torch.float32, max_steps=3,
                                  device=dev)
        res = runner.run_legacy(mode=mode)
        xs = res.x_history
        log(f"[closed] (d) legacy {mode}: steps {len(res.steps)} x_end {xs[-1].tolist()} "
            f"replan_ms {runner.metrics.series['replan_ms']}")
        check(not res.aborted_infeasible and len(res.steps) == 3,
              f"closed (d): legacy {mode} aborted or short")
        check(not any(s.fixtime for s in res.steps), f"closed (d): legacy {mode} fix time")
        check(xs[-1][0] > xs[0][0] and 1.7 < xs[:, 1].min() and xs[:, 1].max() < 8.3,
              f"closed (d): legacy {mode} no progress or out of the band")

    # (e) a profiler window over demo3's first fix-time replan (k = 3)
    rec = ClosedLoopRunner(get_demo("demo3"), dtype=torch.float32, max_steps=4,
                           device=dev, record_problems=True)
    rec.run()
    problem = rec.problems[3]
    check(problem["fixtime"], "closed (e): demo3 step 3 is not a fix-time replan")
    for mode in ("host", "graph"):
        runner = ClosedLoopRunner(get_demo("demo3"), dtype=torch.float32, device=dev,
                                  loop=mode)
        prof = _profile_replan(runner, problem, 5, mode)
        log(f"[closed] (e) demo3 k=3 fix-time replan, {mode} loop: " + json.dumps(prof))
    log(f"[closed] phase 11 {time.perf_counter() - t_phase:.1f} s")
    return counts


def _same_bits(a, b):
    """Bit for bit, NaN where NaN."""
    return _bit_equal(a, b) if a.is_floating_point() else bool((a == b).all())


class _Buckets:
    """A solver whose ``iterate`` calls are recorded as (lanes, cap): the
    buckets :func:`solve_compacted` ran."""

    def __init__(self, solve):
        self.solve, self.calls = solve, []
        self.init, self.finalize, self.options = solve.init, solve.finalize, solve.options

    def iterate(self, st, data, cap):
        self.calls.append((int(st.it.shape[0]), int(cap)))
        return self.solve.iterate(st, data, cap)


# solve_compacted's two parameter sets of phase 13: bench.py's
# (bench.py:112-113, min_bucket = B // 4 at B = 256) and the JAX package's
# defaults, whose last bucket of 16 lanes takes step_linesearch's spread route
COMPACT_SETS = {"bench": dict(chunk=24, min_bucket=64, shrink=4),
                "jax_defaults": dict(chunk=16, min_bucket=16, shrink=4)}
# phase 8's sweep (scenarios, reference paths, final state and trajectory),
# kept for phase 13's resume check
SWEEP_RUN = {}


def _compaction(dev, smi, reps=7, B=256):
    """Phase 13 (1): demo9 N = 10, B = 256 under BENCH_FREE_OPTIONS, solved
    monolithically and by solve_compacted with both parameter sets, in
    float32 and float64: every lane's iterations, feas, converged and z
    bits equal; lane_iters and dispatched_lane_iters; solves/s (median of
    ``reps`` after the counted run); captures and routes per bucket."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        loop, make_obca_solver, solve_compacted)

    opt = BENCH_FREE_OPTIONS
    counts = {k: 0 for k in kernels.launches}
    failed = []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        spec, data, _, _ = demo9_window_batch(B, dtype=dtype, device=dev)
        solve = make_obca_solver(spec, opt)
        width = kernels.pack_obca_data(data).shape[1]
        lay = solve.layout.lay
        kernels.reset_launch_counts()
        loop.reset_stats()
        mono = solve(data)
        torch.cuda.synchronize()
        it = mono.iters.cpu().numpy()
        runs = {"monolithic": (lambda: solve(data), mono, None)}
        routes_of = {}
        for label, kw in COMPACT_SETS.items():
            rec = _Buckets(solve)
            before = loop.stats["captures"]
            comp, stats = solve_compacted(rec, data, **kw)
            torch.cuda.synchronize()
            sizes = sorted({b for b, _ in rec.calls}, reverse=True)
            routes = {b: {"linesearch": kernels.ls_route(lay, width, b, opt.n_backtracks,
                                                         dtype).route,
                          "provider_one_launch": bool(kernels.provider_launch_plan(
                              spec, lay, width, b, dtype).lane),
                          "schur_tiles_a_lane": int(kernels.schur_launch_plan(
                              spec, lay, opt.n_deltas, b, dtype).tiles)}
                      for b in sizes}
            same = {f: _same_bits(getattr(comp, f), getattr(mono, f))
                    for f in ("iters", "feas", "converged", "s", "y", "w", "f", "kkt_err",
                              "viol")}
            same.update({f"z.{k}": _same_bits(comp.z[k], mono.z[k]) for k in mono.z})
            info = {"card": smi, "dtype": tag, **kw, "buckets": rec.calls,
                    "routes": routes, "new_captures": loop.stats["captures"] - before,
                    "stats": stats, "convoy_lane_iters": B * int(it.max()),
                    "lane_iters_sum": int(it.sum()), "bit_equal": same}
            log(f"[compact] {label}: " + json.dumps(info))
            if not all(same.values()):
                bad = np.nonzero(
                    (comp.iters != mono.iters).cpu().numpy()
                    | ~np.all([(comp.z[k] == mono.z[k]).reshape(B, -1).all(1).cpu().numpy()
                               for k in mono.z], axis=0))[0]
                log(f"[compact] {label} {tag}: lanes differing from the monolithic solve "
                    f"{bad.tolist()}, iterations {it[bad].tolist()} against "
                    f"{comp.iters.cpu().numpy()[bad].tolist()}")
            if not all(same.values()):
                failed.append(f"{label} {tag} differs from the monolithic solve: "
                              f"{[f for f, v in same.items() if not v]}")
            check(stats["lane_iters"] == int(it.sum()), f"compact: {label} {tag} lane_iters")
            check(stats["dispatched_lane_iters"] <= B * int(it.max()) + B * kw["chunk"],
                  f"compact: {label} {tag} dispatched {stats['dispatched_lane_iters']}")
            runs[label] = (lambda kw=kw: solve_compacted(solve, data, **kw)[0], comp, rec)
            routes_of[label] = routes
        check(any(r["linesearch"] == "spread" for r in routes_of["jax_defaults"].values()),
              "compact: the JAX defaults' buckets never took the spread route")
        c = dict(kernels.launches)
        check(all(c[k] > 0 for k in FUSED + ("ipm_freeze",)), f"compact {tag}: launches {c}")
        for k in counts:
            counts[k] += c[k]
        rates = {}
        for label, (fn, _, _) in runs.items():
            times, _ = _timed_runs(fn, reps)
            rates[label] = {"solves_per_s": B / statistics.median(times), "seconds": times}
        # a chunk boundary's own cost: the graph loop's copy in and clone out
        # of the state (an iterate call with no lane active), and a bucket's
        # gather of the state and the data (64 lanes)
        st0 = solve.init(data)
        idx = torch.arange(0, B, B // 64, device=dev)
        costs = {"boundary_ms": time_ms(lambda: solve.iterate(st0, data, 0)),
                 "gather64_ms": time_ms(lambda: (type(st0)(*[t.index_select(0, idx) for t in st0]),
                                                 type(data)(*[t.index_select(0, idx)
                                                              for t in data])))}
        log(f"[compact] {tag} timing (median of {reps}, host clock, {smi}): "
            + json.dumps({"slowest_lane_iters": int(it.max()), **rates,
                          "cuda_events": costs}))
    log(f"[compact] launches {counts}")
    check(not failed, "compact: " + "; ".join(failed))
    return counts


def _resume(dev, ckdir, B=1024, steps=30):
    """Phase 13 (2): phase 8's sweep (1024 worlds, float32, QR rescue on) as
    15 steps, the LoopState through SweepCheckpointer (saved, the latest
    loaded back, made tensors on the card), then 15 steps more with
    ``rollout(..., st0=)``: every field of the final state and of the
    trajectory equal to one 30-step run's bit for bit (phase 8's run, or
    one made here)."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        sweep_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        LoopState, make_scan_rollout)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.utils import (
        SweepCheckpointer)

    dtype = torch.float32
    if not SWEEP_RUN:
        scn, shape, p, ref, ref_len = sweep_inputs(B, seed=0, dtype=dtype, device=dev)
        roll = make_scan_rollout(shape, p, max_steps=steps, dtype=dtype, qr_rescue=True,
                                 device=dev)
        final, traj = roll(scn, ref, ref_len)
        SWEEP_RUN.update(scn=scn, shape=shape, p=p, ref=ref, ref_len=ref_len, final=final,
                         traj=traj, source="phase 13")
    r = SWEEP_RUN
    half = make_scan_rollout(r["shape"], r["p"], max_steps=steps // 2, dtype=dtype,
                             qr_rescue=True, device=dev)
    t0 = time.perf_counter()
    mid, traj1 = half(r["scn"], r["ref"], r["ref_len"])
    ck = SweepCheckpointer(ckdir, keep=2)
    t1 = time.perf_counter()
    path = ck.save(steps // 2, {"state": mid, "traj": traj1})
    step, saved = ck.latest()
    st0 = LoopState(**{k: torch.as_tensor(v, device=dev) for k, v in saved["state"].items()})
    t_ck = time.perf_counter() - t1
    end, traj2 = half(r["scn"], r["ref"], r["ref_len"], st0=st0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(step == steps // 2, f"resume: latest() gave step {step}")
    diff = [f for f, a, b in zip(LoopState._fields, r["final"], end) if not _same_bits(a, b)]
    diff += [f"traj.{k}" for k in r["traj"] if not _same_bits(
        r["traj"][k], torch.cat([torch.as_tensor(saved["traj"][k], device=dev), traj2[k]], 1))]
    log(f"[resume] {r['scn'].start.shape[0]} worlds, {steps // 2} + {steps // 2} steps through a checkpoint "
        f"({os.path.getsize(path)} bytes, save + load {t_ck:.3f} s; both halves {wall:.1f} s) "
        f"against one {steps}-step run ({r['source']}): fields differing {diff}, "
        f"replans {int(r['traj']['active'].sum())}")
    check(not diff, f"resume: the resumed sweep differs from one run in {diff}")


def _native_astar():
    """Phase 13 (3): the native A* on every demo grid: each search's cells
    equal the batch entry's over the same starts (the demo's start and
    cells along its path), its cost the Python search's; host times."""
    import math

    import numpy as np

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.native import (
        astar_solve_batch_native, astar_solve_native, load_native_astar)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        astar_host)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario, demo_names, get_demo)

    t0 = time.perf_counter()
    load_native_astar()
    log(f"[astar-native] g++ build and load {time.perf_counter() - t0:.2f} s (host)")
    cost = lambda c: sum(math.hypot(a[0] - b[0], a[1] - b[1]) for a, b in zip(c[:-1], c[1:]))
    for name in demo_names():
        demo = get_demo(name)
        scn, _ = build_scenario(demo, device="cpu")
        grid = scn.grid.numpy()
        s = (int(demo.start[1]), int(demo.start[0]))
        g = (int(demo.goal[1]), int(demo.goal[0]))
        t0 = time.perf_counter()
        route = astar_host.solve_grid_astar(grid, s, g)
        t_py = time.perf_counter() - t0
        check(route is not None, f"astar-native: {name} unreachable in Python")
        starts = [s] + [tuple(c) for c in route[1::max(1, len(route) // 7)]][:7]
        t0 = time.perf_counter()
        single = [astar_solve_native(grid, st, g) for st in starts]
        t_nat = (time.perf_counter() - t0) / len(starts)
        batch = astar_solve_batch_native(grid, np.asarray(starts), np.asarray([g] * len(starts)))
        check(all(a is not None and np.array_equal(a, b) for a, b in zip(single, batch)),
              f"astar-native: {name} single and batch cells differ")
        c_nat, c_py = cost(single[0]), cost(list(route) + [s])
        check(abs(c_nat - c_py) <= 1e-6, f"astar-native: {name} cost {c_nat} != {c_py}")
        log(f"[astar-native] {name}: {len(single[0])} cells, cost {c_nat:.6f} (Python "
            f"{c_py:.6f}), {len(starts)} starts equal to the batch entry; host ms: native "
            f"{1e3 * t_nat:.3f}, Python {1e3 * t_py:.3f}")


def phase_runtime(dev, smi):
    """Phase 13: the runtime modules: lane compaction on
    the free batch, checkpoint / resume of the sweep, the native A*."""
    import tempfile

    t_phase = time.perf_counter()
    counts = _compaction(dev, smi)
    work = os.path.join(HERE, "scratch_chip")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase13_ckpt_", dir=work) as ckdir:
        _resume(dev, ckdir)
    _native_astar()
    log(f"[runtime] phase 13 {time.perf_counter() - t_phase:.1f} s")
    return counts


def _tiny_nlp(dev):
    """Phase 14 (a): the tiny NLP of the JAX package's
    tests/test_solver.py:32 through build_solver on the card in float64,
    against scipy's SLSQP (1e-5)."""
    import numpy as np
    import torch
    from scipy.optimize import minimize

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        build_solver)

    f = lambda z, p: (z["x"] - 2.0) ** 2 + (z["y"] - 1.0) ** 2
    cE = lambda z, p: torch.stack([z["x"] + z["y"] - 2.0])
    cI = lambda z, p: torch.stack([z["x"] - 0.5, z["y"] - z["x"] ** 2 + 1.0])
    solve = build_solver(f, cE, cI, {"x": np.zeros(()), "y": np.zeros(())})
    z0 = {k: torch.zeros(1, dtype=torch.float64, device=dev) for k in ("x", "y")}
    r = solve(z0, None)
    check(bool(r.converged[0]), "ad (a): the tiny NLP did not converge")
    ref = minimize(lambda v: (v[0] - 2) ** 2 + (v[1] - 1) ** 2, [0, 0], method="SLSQP",
                   constraints=[{"type": "eq", "fun": lambda v: v[0] + v[1] - 2},
                                {"type": "ineq",
                                 "fun": lambda v: np.array([v[0] - 0.5, v[1] - v[0] ** 2 + 1])}])
    gap = max(abs(r.z["x"].item() - ref.x[0]), abs(r.z["y"].item() - ref.x[1]))
    check(gap <= 1e-5, f"ad (a): the tiny NLP is {gap:.3e} from SLSQP")
    log(f"[ad] (a) tiny NLP float64: iters {int(r.iters[0])} loop {solve.loop_of(r.s)} "
        f"family {solve.family}, |z - SLSQP| {gap:.3e}")


def _lanes(data, n):
    return type(data)(*[t[:n].contiguous() for t in data])


def _zgap(ra, rb, lanes=None):
    """Largest |z_a - z_b| over the variables (on ``lanes`` where given)."""
    sel = (lambda t: t) if lanes is None else (lambda t: t[lanes])
    return max((sel(ra.z[k]) - sel(rb.z[k])).abs().max().item() if sel(ra.z[k]).numel() else 0.0
               for k in ra.z)


def _zrel(ra, rb):
    """|z_a - z_b|_max / |z_b|_max over every variable: phase 3's
    max-normalised error."""
    return _zgap(ra, rb) / max(max(v.abs().max().item() for v in rb.z.values()), 1e-300)


def phase_ad(dev, smi, B=256):
    """Phase 14: the AD solver (solver/ad.py build_solver) and the new
    modules on the card. Returns the launches of the AD solves."""
    import tempfile

    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.parallel import (
        make_mesh, sharded_batch_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        build_obca_ad_solver, loop as sloop, make_obca_solver, qr)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.utils import (
        annotate, device_trace)

    t_phase = time.perf_counter()
    counts = {k: 0 for k in kernels.launches}

    def counted(fn):
        """Run ``fn`` with the launch counts from 0; add them to the phase's."""
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        run = dict(kernels.launches)
        for k, v in run.items():
            counts[k] += v
        return out, run

    _tiny_nlp(dev)
    opt_a = dataclasses.replace(BENCH_FREE_OPTIONS, kkt="arrow")

    # (b) the arrow family at the free batch's width, both dtypes
    f64_runs = {}
    for dtype in (torch.float32, torch.float64):
        dn = "f64" if dtype == torch.float64 else "f32"
        spec, data, _, _ = demo9_window_batch(B, dtype=dtype, device=dev)
        out = {}
        for label, opts, impl, reps in (("arrow", opt_a, None, 2), ("arrow plain", opt_a, "plain", 0),
                                        ("fused", BENCH_FREE_OPTIONS, None, 2)):
            solve = make_obca_solver(spec, opts, impl=impl)
            sloop.reset_stats()
            t0 = time.perf_counter()
            if label == "arrow plain":
                kernels.reset_launch_counts()
                r = solve(data)
                torch.cuda.synchronize()
                run = dict(kernels.launches)
            else:
                r, run = counted(lambda: solve(data))
            first_s = time.perf_counter() - t0
            times, _ = _timed_runs(lambda: solve(data), reps) if reps else ([first_s], None)
            st = _batch_stats(r, B)
            st.update(solves_per_s=B / statistics.median(times), seconds=times,
                      loop=solve.loop_of(data.x0) if solve.loop_of else "graph",
                      captures=sloop.stats["captures"],
                      launches={k: v for k, v in run.items() if v})
            log(f"[ad] (b) {label} {dn} B={B}: " + json.dumps(st))
            out[label] = (r, st, run)
        rk, sk, runk = out["arrow"]
        rp, sp, runp = out["arrow plain"]
        check(sk["loop"] == "graph" and sp["loop"] == "host", f"ad (b) {dn}: loops {sk['loop']}, "
              f"{sp['loop']}")
        check(runk["spd_inv"] > 0 and runk["ipm_freeze"] > 0,
              f"ad (b) {dn}: spd_inv / ipm_freeze not launched: {runk}")
        check(all(v == 0 for v in runp.values()), f"ad (b) {dn}: the plain run launched {runp}")
        for lb, st in (("kernels", sk), ("plain", sp)):
            check(st["feasible_fraction"] >= 0.99,
                  f"ad (b) {dn} {lb}: feasible fraction {st['feasible_fraction']:.4f} < 0.99")
        same = float((rk.iters == rp.iters).float().mean())
        dz, rel = _zgap(rk, rp), _zrel(rk, rp)
        log(f"[ad] (b) arrow kernels vs plain {dn}: same iters on {same:.4f} of lanes, "
            f"max |dz| {dz:.3e}, max-normalised {rel:.3e}")
        if dtype == torch.float64:
            check(same == 1.0 and rel <= 1e-9,
                  f"ad (b) f64: kernels vs plain same iters on {same:.4f}, |dz| {dz:.3e} "
                  f"(max-normalised {rel:.3e})")
            rf = out["fused"][0]
            both = rk.feas & rf.feas
            near = float(((rk.iters - rf.iters).abs() <= 1).float().mean())
            log(f"[ad] (b) arrow vs fused f64: |diters| <= 1 on {near:.4f} of lanes, "
                f"max |dz| on {int(both.sum())} lanes feasible in both {_zgap(rk, rf, both):.3e}")
            f64_runs = dict(spec=spec, data=data, arrow=rk)
        del out
        torch.cuda.empty_cache()

    # (c) the dense families on the first 16 lanes, float64
    spec, data16 = f64_runs["spec"], _lanes(f64_runs["data"], 16)
    z0 = init_vars(spec, data16)
    ra16, _ = counted(lambda: make_obca_solver(spec, opt_a)(data16))
    seen = []
    real_dense = qr.kkt_qr_dense

    def record(K, rhs, n, *, impl=None):
        if not seen and impl is None:
            seen.append((K.clone(), rhs.clone(), n))
        return real_dense(K, rhs, n, impl=impl)

    dense = {}
    for kkt in ("al_chol", "chol", "qr", "arrow_dense"):
        # chol demands W + delta I itself SPD, "too strong for OBCA" (the JAX
        # package's solver/ipm.py:114-115): its lanes run to the cap, so it
        # stops at 25 iterations here, a quarter of the time of 100;
        # arrow_dense is arrow without Hessian coloring (a dense Hessian)
        o = dataclasses.replace(opt_a, kkt=kkt, **({"max_iters": 25} if kkt == "chol" else {}))
        if kkt == "arrow_dense":
            o = dataclasses.replace(opt_a, hessian_coloring=False)
        res = {}
        for label, impl in (("kernels", None), ("plain", "plain")):
            if kkt == "qr":
                solve = build_obca_ad_solver(spec, o, impl=impl)
                call = lambda: solve(z0, data16)
            else:
                solve = make_obca_solver(spec, o, impl=impl)
                call = lambda: solve(data16)
            t0 = time.perf_counter()
            qr.kkt_qr_dense = record
            try:
                if impl is None:
                    r, run = counted(call)
                else:
                    kernels.reset_launch_counts()
                    r = call()
                    torch.cuda.synchronize()
                    run = dict(kernels.launches)
            finally:
                qr.kkt_qr_dense = real_dense
            res[label] = (r, run, time.perf_counter() - t0, solve.loop_of(data16.x0))
        check(solve.family == kkt, f"ad (c) {kkt}: the solver runs {solve.family}")
        (rk, runk, tk, lk), (rp, runp, tp, lp) = res["kernels"], res["plain"]
        same = float((rk.iters == rp.iters).float().mean())
        dz, rel = _zgap(rk, rp), _zrel(rk, rp)
        row = {"loop": lk, "plain_loop": lp, "feasible_fraction": float(rk.feas.float().mean()),
               "iters_max": int(rk.iters.max()), "same_iters": same, "max_dz": dz,
               "max_dz_rel": rel, "seconds": tk, "plain_seconds": tp,
               "launches": {k: v for k, v in runk.items() if v}}
        check(same == 1.0 and rel <= 1e-9, f"ad (c) {kkt}: kernels vs plain same iters on "
              f"{same:.4f}, |dz| {dz:.3e} (max-normalised {rel:.3e})")
        check(all(v == 0 for v in runp.values()), f"ad (c) {kkt}: the plain run launched {runp}")
        check(runk["ipm_freeze"] > 0, f"ad (c) {kkt}: ipm_freeze not launched: {runk}")
        if kkt == "al_chol":
            sa = float((rk.iters == ra16.iters).float().mean())
            da = _zgap(rk, ra16)
            row.update(same_iters_arrow=sa, max_dz_arrow=da)
            check(sa == 1.0 and da <= 1e-6,
                  f"ad (c) al_chol vs arrow: same iters on {sa:.4f}, |dz| {da:.3e}")
        if kkt == "qr":
            check(runk["kkt_qr_dense"] > 0, f"ad (c) qr: kkt_qr_dense not launched: {runk}")
        log(f"[ad] (c) {kkt} f64 16 lanes: " + json.dumps(row))
        dense[kkt] = row
    check(all(r["loop"] == "graph" and r["plain_loop"] == "host" for r in dense.values()),
          f"ad (c): loops {[(k, r['loop'], r['plain_loop']) for k, r in dense.items()]}")

    # (d) kkt_qr_dense on one rung of (c)'s qr solve: its first saddle matrices
    check(bool(seen), "ad (d): the qr family's saddle matrices were not recorded")
    K, rhs, n = seen[0]
    kernels.reset_launch_counts()
    dense_row = check_qr_dense(K[:, :1].contiguous(), rhs, n, "ad qr rung", True)

    # (e) profiling and the split
    work = os.path.join(HERE, "scratch_chip")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase14_trace_", dir=work) as td:
        solve = make_obca_solver(spec, opt_a)
        with device_trace(td) as prof:
            with annotate("ad_arrow_solve"):
                solve(data16)
        with open(prof.trace_path) as fh:
            trace = json.load(fh)
        names = [e.get("name", "") for e in trace.get("traceEvents", [])]
        has_ann = any(nm == "ad_arrow_solve" for nm in names)
        spd_ev = sum(1 for e in trace.get("traceEvents", [])
                     if "spd_" in e.get("name", "") and e.get("cat") == "kernel")
        check(has_ann and spd_ev > 0,
              f"ad (e): trace has the annotation {has_ann}, spd_inv kernel events {spd_ev}")
        log(f"[ad] (e) device_trace: {len(names)} events, annotation found, "
            f"{spd_ev} spd_inv kernel events")
    mesh = make_mesh()
    solve = make_obca_solver(spec, opt_a)
    r1 = solve(data16)
    r2 = sharded_batch_solver(solve, mesh)(data16)
    same = all(_bit_equal(a, b) for a, b in zip(
        [r1.iters.double(), *r1.z.values()], [r2.iters.double(), *r2.z.values()]))
    check(same, "ad (e): the sharded solve differs from the unsharded one")
    log(f"[ad] (e) sharded_batch_solver over {len(mesh)} device(s): bit-equal")
    log(f"[ad] phase 14 {time.perf_counter() - t_phase:.1f} s, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts, dense_row


def _tree_same_bits(a, b):
    """Two outputs (trees of tensors) bit for bit, NaN where NaN."""
    from torch.utils import _pytree

    la, lb = _pytree.tree_leaves(a), _pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and _same_bits(x, y) for x, y in zip(la, lb))


def _device_loop_solves(dev):
    """Phase 15's solves: label -> make(loop mode) -> a call that solves."""
    import dataclasses

    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, FIX8_OPTIONS, demo9_window_batch, fix_fixture_batch,
        make_fix_step, make_openloop_solve, openloop_n74_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
        make_multistart_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    f32, f64 = torch.float32, torch.float64
    free = demo9_window_batch(256, dtype=f32, device=dev)
    free64 = demo9_window_batch(64, dtype=f64, device=dev)
    fix = fix_fixture_batch(256, dtype=f32, device=dev)
    fix64 = fix_fixture_batch(32, dtype=f64, device=dev)
    n74 = openloop_n74_inputs(f64, dev)
    qr8 = dataclasses.replace(FIX8_OPTIONS, kkt="qr")
    arrow = dataclasses.replace(BENCH_FREE_OPTIONS, kkt="arrow")

    def solver(spec, opt, data):
        return lambda m: (lambda s: lambda: s(data))(make_obca_solver(spec, opt, loop=m))

    def multistart(ms_of, data, cands):
        return lambda m: (lambda ms: lambda: ms(data, cands))(ms_of(m))

    cases = {
        "free f32 B=256": solver(free[0], BENCH_FREE_OPTIONS, free[1]),
        "free f64 B=64": solver(free64[0], BENCH_FREE_OPTIONS, free64[1]),
        "fix step f32 256x5": multistart(
            lambda m: make_fix_step(fix[0], fix[1], qr_rescue=True, loop=m), fix[2], fix[3]),
        "qr rung f64 32x5": multistart(
            lambda m: make_multistart_solver(fix64[1], make_obca_solver(fix64[1], qr8, loop=m),
                                             init_vars, 5), fix64[2], fix64[3]),
        "open N=74 f64": multistart(lambda m: make_openloop_solve(n74[0], n74[3], loop=m),
                                    n74[1], n74[2]),
        "ad arrow f64 B=64": solver(free64[0], arrow, free64[1]),
    }
    return cases, fix


def phase_device_loop(dev, smi, reps=3):
    """Phase 15: the device loop (kernels/csrc/device_loop.cu): each solve
    one CUDA graph whose Newton iterations run under a conditional WHILE
    node. Every solve of _device_loop_solves bit-equal to loop="host"
    (both dtypes, the fix step's four rungs, a QR rung, the N = 74 open
    loop, the AD arrow family), host seconds of both (median of ``reps``
    after the first call, which captures), iterations and ms an iteration;
    a multistart with set_sync_debug_mode("error") between its launch and
    its result read; graphs built and instantiate ms."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, FIX6_OPTIONS, demo9_window_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
        make_multistart_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        loop, make_obca_solver)

    t_phase = time.perf_counter()
    versions = kernels.device_loop_versions()
    log(f"[device_loop] CUDA runtime {versions['runtime']}, driver {versions['driver']}, "
        f"built with {versions['built']}, torch {torch.__version__} ({torch.version.cuda})")
    cases, fix = _device_loop_solves(dev)
    kernels.reset_launch_counts()
    loop.reset_stats()
    solves = {}
    for label, make in cases.items():
        before = dict(loop.stats)
        times_g, out_g = _timed_runs(make(None), 1 + reps)
        built = {k: loop.stats[k] - before[k] for k in ("captures", "instantiate_ms", "build_ms")}
        iters = (loop.stats["replays"] - before["replays"]) // (1 + reps)
        launches = (loop.stats["launches"] - before["launches"]) // (1 + reps)
        times_h, out_h = _timed_runs(make("host"), 1 + reps)
        same = _tree_same_bits(out_g, out_h)
        g_s, h_s = statistics.median(times_g[1:]), statistics.median(times_h[1:])
        row = {"bit_equal": same, "graph_launches_a_call": launches, "iterations_a_call": iters,
               "graph_s": g_s, "host_s": h_s, "first_call_s": times_g[0],
               "graph_ms_per_iteration": 1e3 * g_s / max(iters, 1),
               "host_ms_per_iteration": 1e3 * h_s / max(iters, 1), **built}
        log(f"[device_loop] {label}: " + json.dumps(row))
        check(same, f"device_loop: {label} differs from loop='host'")
        check(launches >= 1 and iters > 0, f"device_loop: {label} ran no graph ({row})")
        solves[label] = row
        del out_g, out_h
    counts = dict(kernels.launches)
    graphs = {k: loop.stats[k] for k in ("captures", "instantiate_ms", "build_ms")}
    log(f"[device_loop] graphs {json.dumps(graphs)} launches {counts}")
    check(all(counts[k] > 0 for k in FUSED + ("ipm_freeze", "kkt_qr", "device_loop")),
          f"device_loop: launches {counts}")

    # no host synchronisation between a multistart's launch and its result read
    spec6, _, data, cands = fix
    ms = make_multistart_solver(spec6, make_obca_solver(spec6, FIX6_OPTIONS), init_vars, 5)
    ms(data, cands)
    torch.cuda.synchronize()
    launch, read = kernels.device_loop_launch, loop._iterations
    armed = []

    def launch_then_arm(*a):
        launch(*a)
        torch.cuda.set_sync_debug_mode("error")
        armed.append(1)

    def disarm_then_read(p):
        torch.cuda.set_sync_debug_mode("default")
        return read(p)

    try:
        kernels.device_loop_launch, loop._iterations = launch_then_arm, disarm_then_read
        ms(data._replace(x0=data.x0 + 0.01), cands)
    finally:
        kernels.device_loop_launch, loop._iterations = launch, read
        torch.cuda.set_sync_debug_mode("default")
    check(armed == [1], f"device_loop: the sync check saw {len(armed)} launches")
    log("[device_loop] fix step mpc6 (256 x 5, float32) under set_sync_debug_mode('error') "
        "from its launch to its result read: no host synchronisation")

    # the kernels line: the free batch's solve, graphed against the host loop
    # (CUDA events around a call, host work included); the loop's own
    # kernels move the flag and the count, 8 bytes an iteration
    spec, data, _, _ = demo9_window_batch(256, dtype=torch.float32, device=dev)
    solver_g, solver_h = (make_obca_solver(spec, BENCH_FREE_OPTIONS, loop=m)
                          for m in (None, "host"))
    ms_g = time_ms(lambda: solver_g(data), reps=5, warm=1)
    ms_h = time_ms(lambda: solver_h(data), reps=5, warm=1)
    iters = solves["free f32 B=256"]["iterations_a_call"]
    b_ms, b_by = bound(8 * (iters + 1), 0, torch.float32)
    log(f"[device_loop] phase 15 {time.perf_counter() - t_phase:.1f} s")
    return counts, {"abs": 0.0, "ms": ms_g, "plain_ms": ms_h, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None, "solves": solves, "graphs": graphs,
                    "versions": versions, "card": smi}


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        __import__(PKG)
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    no_jax("import")
    phases = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}
    if "--phases" in argv:
        phases = {int(p) for p in argv[argv.index("--phases") + 1].split(",")}
    dev = torch.device("cuda:0")

    smi = phase_card()
    phase_build()
    no_jax("build")
    report, counts = {}, {}
    if 3 in phases:
        report = phase_kernels(dev)
        no_jax("phase 3")
    if 4 in phases:
        phase_entry(dev)
        no_jax("phase 4")
    if 5 in phases:
        phase_batch(dev)
        no_jax("phase 5")
    if 6 in phases:
        counts[6] = phase_fixstep(dev)
        no_jax("phase 6")
    if 7 in phases:
        counts[7] = phase_qr(dev)
        no_jax("phase 7")
    if 8 in phases:
        counts[8] = phase_sweep(dev)
        no_jax("phase 8")
    if 9 in phases:
        counts[9] = phase_demos(dev)
        no_jax("phase 9")
    if 10 in phases:
        counts[10] = phase_openloop(dev)
        no_jax("phase 10")
    if 11 in phases:
        counts[11] = phase_closed(dev)
        no_jax("phase 11")
    if 12 in phases:
        counts[12] = phase_variants(dev)
        no_jax("phase 12")
    if 13 in phases:
        counts[13] = phase_runtime(dev, smi)
        no_jax("phase 13")
    ad_dense = None
    if 14 in phases:
        counts[14], ad_dense = phase_ad(dev, smi)
        no_jax("phase 14")
    if 15 in phases:
        counts[15], report["device_loop"] = phase_device_loop(dev, smi)
        no_jax("phase 15")

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import (
        SOURCE_OF)

    if 3 in phases and all(ph in counts for ph in (8, 10, 11, 15)):
        rows = []
        for name in REPLACES:
            r = report[name]
            rows.append({"name": name, "route": "cuda",
                         "source": f"{PKG}/kernels/csrc/{SOURCE_OF[name]}.cu",
                         "replaces": REPLACES[name],
                         "launches": counts[MAIN_PHASE.get(name, 8)][name],
                         "launches_by_phase": {str(ph): c[name] for ph, c in counts.items()},
                         "max_abs_err": r["abs"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
            # the redesigned kernels' second shape: the open loop's N = 74
            # (5 lanes) and a sweep rescue rung's batch (16 lanes x R = 2)
            extra = {"newton_assemble": ("N74", report.get("newton_assemble N74")),
                     "kkt_qr": ("sweep_batch", r.get("sweep_batch"))}.get(name)
            if extra and extra[1]:
                rows[-1][extra[0]] = {k: extra[1][k] for k in TIME_KEYS}
            if name == "kkt_qr":   # the dense entry (kkt_qr_dense): the sweep batch, the AD qr rung
                dn = {"sweep_batch": (r.get("sweep_batch") or {}).get("dense"), "ad_qr": ad_dense}
                rows[-1]["dense"] = {
                    lb: {k: d[k] for k in ("matrices", "M", "graph_ms", "abs", *TIME_KEYS)
                         if k in d}
                    for lb, d in dn.items() if d}
                rows[-1]["dense"]["launches_by_phase"] = {
                    str(ph): c["kkt_qr_dense"] for ph, c in counts.items()}
            if "graph_ms" in r:   # device time alone, inside a CUDA graph
                rows[-1]["graph_ms"] = r["graph_ms"]
            if name == "obca_kkt_provider":   # its plan and times at every main path's shape
                rows[-1]["shapes"] = {
                    lb: {k: p[k] for k in ("lanes", "ctas_per_lane", "graph_ms", "ms", "bound_ms",
                                           "bound_by")}
                    for lb, p in report.get("obca_kkt_provider shapes", {}).items()}
            if name == "newton_al_solve":   # its route and times at every main path's shape
                rows[-1]["shapes"] = {
                    lb: {k: s[k] for k in ("route", "graph_ms", *TIME_KEYS)
                         if k in s}
                    for lb, s in report.get("newton_al_solve shapes", {}).items()}
            if name == "step_linesearch":   # its route, times and trials at every main path's shape
                rows[-1]["ls_route"] = r["route"]
                rows[-1]["shapes"] = {
                    lb: {k: s[k] for k in ("route", "trials", "graph_ms", *TIME_KEYS) if k in s}
                    for lb, s in report.get("step_linesearch shapes", {}).items()}
            if name == "newton_schur":   # its tiles and times at every main path's shape
                rows[-1]["shapes"] = {
                    lb: {k: p[k] for k in ("lanes", "tiles", "rows", "graph_ms", "ms", "bound_ms",
                                           "bound_by")}
                    for lb, p in report.get("newton_schur shapes", {}).items()}
            if name in ASTAR:   # its route and times at the sweep's and the demos' maps
                rows[-1]["shapes"] = report.get(f"{name} shapes", {})
            if name == "ipm_freeze":   # its times and bounds at every main path's shape
                rows[-1]["shapes"] = report.get("ipm_freeze shapes", {})
            if name == "device_loop":   # each solve of phase 15 against the host loop
                rows[-1]["solves"] = r["solves"]
                rows[-1]["graphs"] = r["graphs"]
            if name in report.get("variants", {}):   # fix_eq_band and coupled motion
                rows[-1]["variants"] = report["variants"][name]
            if name == "spd_inv":   # the two calls of an iteration and their routes
                rows[-1]["shapes"] = {
                    lb: {k: r[lb][k] for k in ("m", "count", "route", "graph_ms", *TIME_KEYS)}
                    for lb in ("m=bq", "m=np") if lb in r}
        print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
