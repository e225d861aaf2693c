#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mcmcdate_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from csrc/ (one nvcc per
   source, all started together) and prints the time;
3. kernels: runs every kernel on the card against its plain PyTorch
   version, at the run's shape (136 taxa x 1024 chains) and at the bench
   shape (1000 taxa x 1024 chains), with the float32 tolerances below:
   K1 prior_terms, K2 whiten (full, gather and range-1024 row lists), the
   sequential sweep's ticket kernels on a synthetic model with node
   priors and the calibrated table (all 17 proposal kinds): T1
   ticket_prologue and K3 accept_select on one ticket of every kind and
   likelihood class, T3 ticket_scan on a 256-ticket run, each checked by
   replaying their proposals and decisions through the plain versions
   (records: T1 and K3 on the pulley, T3 on the FastSweeps leftovers' run
   of a sweep), and on FastSweeps' own plan steps of a synthetic model
   K4 (the likelihood point step: point_lik_prologue, point_scan and
   point_lik_epilogue, a record each on the node slides' first step, the
   prologue's and epilogue's with a second record on the branch scales'
   first step, checked on the first step of both point kinds by replaying
   the kernels' proposals through the plain step; one point_lik_step must
   launch only the three and the z product; at 1000 taxa the slide
   proposals' largest miss over 8 seeds' draws is logged), K5
   (the likelihood range-block step: range_lik_prologue, range_scan and
   range_lik_epilogue, likewise), both without a likelihood as well (the
   prologue and the epilogue alone, the epilogue taking the decisions), K6
   contra_step in its two modes (contra_slide, and contra_range with a
   record per row bucket: contra_range_16, _64 and _256) and, on the
   14 global-move families of the same model with node priors and the
   calibrated proposal table, the glob kernels G1 glob_scan, G2
   glob_dense_prologue and G3 glob_dense_epilogue (checked by replaying
   their proposals and decisions through the plain family scan;
   FastSweeps.glob_phase must launch only them; records: G1 on bd_scale's
   family, G2 per ticket over sub_ultra's, G3 on its first ticket; the
   log adds G1 on sub_contra, G2 on one var_tree ticket, G3 on var_tree's
   first ticket (whole D) and each subtree ticket's product over its
   support rows against the full product; K6's and G3's logs also give
   each bound by the coarser count: K6 without its double operations, G3
   with every chain reading delta, z and w over D).  The six decision
   kernels (K3, T3, K4 point_scan, K5 range_scan, G1, G3) again with the
   128-point stepping-stone ladder tiled over the chains as each chain's
   likelihood temperature and a 4-rung MC3 ladder as its prior temperature
   (check_tempered: K3 and T3's light and heavy kernels replayed as above,
   the scans against their plain versions on the inputs of a tempered
   step, G1 and G3 on all 14 families), and with the MC3 ladder alone the
   sites that take only the prior, K6 in both modes and the K4 and K5
   epilogues' own decisions without a likelihood, each timed flushed with
   the ladders beside ones vectors, in turns (the ``tempered`` key of its
   record); cascade_seed against the per-field copy, bitwise, timed beside
   ``torch._foreach_copy_``, both with the L2 flushed; M1 mc3_swap against its plain version
   (check_mc3_swap: state, U, decisions and per-pair counts bitwise),
   timed flushed beside one ``index_select`` a field.  Each kernel's
   device time and its plain version's are read from the profiler over
   back-to-back calls (K4's prologue and epilogue, K6 slide's and G3's
   kernel with the L2 flushed before each call, so that a call cannot read
   below its bytes bound);
4. main path: simulate -> prepare --likelihood-spec full -> run (MHG,
   FastSweeps) at 136 taxa x 1024 chains through the port's CLI, in a
   temporary directory; checks the outputs, the carried log posterior,
   that the run launched every kernel and no plain proposal kernel, that
   its point steps went through the three K4 kernels alone (as many
   launches of each) and that its sequential phase launched no K1; then,
   on that run's prepared data, marginal likelihood: the CLI's
   marginal-likelihood --profile (12 stones: the annealed cascade, burn-in,
   ML_ITERATIONS iterations): the log's cascade line and a finite log Z,
   the beta = 1 stone's log likelihood above the beta = 0 stone's, every
   decision kernel and 11 cascade_seed launches, no plain proposal or
   plain twin; and ml full ladder: annealed_cascade over all 128 stones,
   ML_CASCADE_SWEEPS sweeps a rung (127 cascade_seed launches, the middle
   rung's seeding bitwise the
   per-field copy's), two chunks with the estimator (a finite log Z), a
   carry check;
5. full width: FastSweeps through ChainRunner at 1000 taxa x 1024 chains
   (D = 1,997) on the synthetic model; median s/sweep, carry check, K4-K6,
   G1-G3 and the ticket kernels launched, the point steps through K4
   alone, the sequential phase without K1 or a plain proposal;
6. prior only: FastSweeps through ChainRunner at 136 taxa x 1024 chains
   on the synthetic model without its likelihood; carry check, the point
   steps and range blocks through their prologue and epilogue kernels
   alone, K6, G1-G3 and T3 launched;
7. sequential path: the same 136-taxon model as the main path through
   RunSettings(fast_sweep=False) (MHKernel); carry check; every sweep
   launches T1, K2 and K3 once per ticket that breaks a run, T3 per run,
   no K1 and no plain proposal;
8. univariate 10k: ChainRunner with the default settings on a univariate
   model of 10,000 taxa x 1024 chains (D = 19,997: the sequential sweep,
   no Cholesky factor); T3 against its plain version on a 256-ticket run
   of light tickets (its warp-per-ticket kernel) and on two heavy tickets
   alone (its CTA-per-chain kernel: a birth-death scale and a subtree
   above 1,024 distances), the light run and the birth-death scale each a
   record of its own (``records_10k`` in the kernels' line); two timed
   sweeps and one whose carried log posterior is checked, every sweep
   through T3 alone, both of its kernels launched;
9. sparse tutorial: the reference tutorials' workflow at 136 taxa x 1024
   chains through the CLI: simulate -> prepare "sparse 0.1" (host BCD, D =
   269; the .data file tagged SparseS) -> run --profile --iterations 20
   (FastSweeps on the dense sparse precision; the main path's checks) ->
   continue --iterations 10 (monitor rows numbered after the checkpoint's
   iteration, the checkpoint advanced, carry check) -> analyze (its files);
10. sparse full width: simulate -> prepare "sparse 0.1" at 1000 taxa (D =
   1,997 > 400: the graphical lasso's ADMM on the card, A1 admm_shift, A2
   admm_eig_scale and A3 admm_update launched once an iteration each) ->
   run --profile --iterations 10 at 1000 taxa x 1024 chains (FastSweeps,
   carry check).  On that prepare's own S the whole ADMM runs again by the
   kernels (bitwise the prepare's) and by the plain versions on the card
   (the same iterations and zero pattern, Theta and W within
   ADMM_THETA_TOL), and A1-A3 are held to their plain versions on one more
   iteration (A1, A2 and A3's Z and U bitwise, A3's sums within
   ADMM_SUM_REL) and timed flushed, beside eigh's and the product's device
   times (the A1-A3 records; their ``launches`` are this path's);
11. banded tutorial: simulate -> prepare "banded 128" (the host's Cholesky
   banding estimator, D = 269; the .data file tagged BandedS) -> run
   --profile --iterations 20 (FastSweeps, every precision and Cholesky
   product through B1 band_matmul and B2 band_matmul_t; the main path's
   carry check) -> analyze at 136 taxa x 1024 chains, then 10 + 1 sweeps of
   MHKernel on that model (T1, B1, K3 per ticket that moves distances);
12. banded full width: FastSweeps through ChainRunner on the synthetic
   banded model of 5,000 taxa x 1024 chains ("banded 128": D = 9,997, 79
   blocks of 128), 10 + 1 sweeps: carry check, s/sweep, B1's, B2's and
   band_rows_add's launches per sweep, their device time in one profiled
   sweep, the sweep's construction time, the device memory's peak.  Both
   banded paths must launch B1 (and on FastSweeps B2, and band_rows_add
   once a point step or range block), never K2 or a plain version, and
   their sweeps hold no [D, D] or [rows, D] tensor.  The kernels phase also
   holds B1 and B2 to their plain versions at 136 and 5,000 taxa on every
   site's shape, whole and windowed, with each reduction, and
   band_rows_add on the plan's largest range block and point step
   (check_band; records at 5,000 taxa, flushed in turns with torch.matmul
   on the densified matrix, flushed too, and band_rows_add's with the
   scatter-and-window path it replaced and z.addmm_ with the block's
   densified rows), and H1 nuts_leapfrog_prologue,
   H2 nuts_leapfrog_epilogue and H3 nuts_merge along whole NUTS
   trajectories of up to 8 doublings (check_nuts: every launch replayed
   through the plain versions from the kernels' state,
   kernels.nuts_step.NutsCheck; some chain of each case doubles at least
   5 times) at 136 and 1000 taxa with node priors and
   the 128-point ladder as beta_lik, at 136 also under the univariate and
   the banded kind (through B1); records at 1000 taxa, flushed; the
   product z = r P (cuBLAS, a library call) on a line of its own beside
   the float64 product;
13. hamiltonian tutorial: simulate -> prepare full -> run --hamiltonian
   --profile (the adaptation and acceptance lines, a finite eps, H1-H3
   and the product launched, no plain twin, the carry check) -> continue
   (NUTS resumed from the checkpoint) -> marginal-likelihood --hamiltonian
   --profile (a finite log Z) at 136 taxa x 1024 chains, then 1 + 1
   MHKernel sweeps with the move;
14. hamiltonian full width: FastSweeps with the NUTS move at 1000 taxa x
   1024 chains: the step size adapted over three windows, then 10 + 1
   sweeps (s/sweep beside the same sweeps without the move, H1-H3
   launches a sweep, mean leapfrog steps a trajectory, the carry check,
   the memory peak).  No path without --hamiltonian launches H1-H3;
15. mc3 tutorial: simulate -> prepare full -> run --mc3 --profile (136
   taxa x 256 groups x 4 temperatures) -> continue, then both with
   --hamiltonian, through the CLI: the JAX package's log lines, the MC3
   meta and mc3_dt, the cold-chain trace, one M1 launch a chunk of two
   sweeps, every kernel of the main path, no plain twin;
16. mc3 full width: run_mc3 at 1000 taxa x 256 groups x 4 temperatures
   (burn-in windows, timed iterations, a continue), with and without the
   NUTS move: the last swap's carried U against a fresh evaluation, every
   pair's swap rate in (0, 1), dt moved in burn-in, s/sweep; and a sweep
   with beta_prior None bitwise one with a ones vector.  No path without
   --mc3 launches M1;
17. optional moves tutorial: simulate -> prepare full at 136 taxa x 1024
   chains, then through the CLI run --profile --bold-contra 0.4
   --bold-factor 8 --fiber-slide 1 --fiber-de 2 -> continue with the same
   flags -> marginal-likelihood --profile --fiber-slide 1 --bold-contra 0.4
   -> run --mc3 --fiber-slide 1 (a few iterations): the log lines, F1
   fiber_slide once a colour class a sweep, F2 fiber_de twice a round (run
   and continue only), K6 range and G1 sub_contra with the bold uniforms,
   the carry checks, no plain twin;
18. optional moves full width: FastSweeps through ChainRunner at 1000 taxa
   x 1024 chains with the three moves, 10 + 1 sweeps (the carry check)
   beside 10 without: s/sweep with and without, the slide's and the DE's
   acceptance.  No path without the flags launches F1, F2 or the bold
   mixture.  The kernels phase holds F1 (class by class) and F2 (a
   half-update) to their plain versions at 136 and 1000 taxa on the model
   with node priors (check_fiber), and K6's range mode and G1's sub_contra
   with the bold uniforms, each timed beside the call without them
   (check_bold, the ``bold`` key of their records).

Every phase after the kernels sets each wrapper's launch count to 0 just
before it and reads it just after (T3's also by kernel: ``light`` and
``heavy``, in ``launches_by_kernel``; every kernel's by path in
``launches_by_path``).  The last two lines of standard output
are the card's name and power limit and, on success, ``{"ok": true,
"device": {...}}``; the line before them is the kernels' JSON record.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_TAXA = 136
BENCH_TAXA = 1000
CHAINS = 1024
TREES = 600
# The main path's iterations after the --profile burn-in (60 sweeps).
# --profile alone would run 50; cut to 20.  The full-width, prior-only and
# sequential phases run 10 sweeps (one chunk) and one more for the carry
# check; the univariate 10k phase UNI_SWEEPS timed sweeps and one more.
# Only sweep counts are cut, never taxa or chains, so that the whole script
# stays inside half its 1200 s limit (PERF.md gives each phase's seconds
# per sweep on an H100).
ITERATIONS = 20
FULL_WIDTH_SWEEPS = 10
PRIOR_ONLY_SWEEPS = 10
SEQUENTIAL_SWEEPS = 10
UNI_TAXA = 10_000
UNI_SWEEPS = 2
# The banded kind: the JAX package's own banded end-to-end shape (5,000 taxa,
# "banded 128": D = 9,997, wb = 128, nb = 79) at the smoke's chain count,
# FULL_WIDTH_SWEEPS + 1 sweeps on FastSweeps; the tutorial path prepares
# "banded 128" at the main path's 136 taxa (D = 269, nb = 3) and adds
# SEQUENTIAL_SWEEPS + 1 sweeps of MHKernel.
BANDED_TAXA = 5000
BANDED_SPEC = "banded 128"
BANDWIDTH = 128
# The sparse paths: the reference tutorials' likelihood spec; the tutorial
# path's continue adds CONTINUE_ITERATIONS to its ITERATIONS, the full-width
# path runs FULL_WIDTH_SWEEPS after the --profile burn-in.
SPARSE_SPEC = "sparse 0.1"
CONTINUE_ITERATIONS = 10
# marginal-likelihood --profile runs 50 iterations after its cascade and
# burn-in; cut to 20.  The ml full ladder's cascade runs ML_CASCADE_SWEEPS
# sweeps a rung (the CLI's 3: cut to 1 to keep the smoke inside its limit).
ML_ITERATIONS = 20
ML_CASCADE_SWEEPS = 1
# The kernels phase's NUTS trajectories: up to NUTS_DEPTH doublings (the
# kernels' MAX_DEPTH, 255 leapfrog steps) at step size NUTS_EPS[taxa], every
# launch replayed (from the perturbed state, whose gradient grows with the
# tree: at 1000 taxa a step of 1e-3 diverges at once, 1e-4 stops after 4
# doublings); some chain of each case doubles at least NUTS_MIN_DEPTH times,
# so the deep U-turn checks and checkpoint slots are replayed (6 at both
# sizes on an H100).
NUTS_DEPTH = 8
NUTS_MIN_DEPTH = 5
NUTS_EPS = {MAIN_TAXA: 1e-3, BENCH_TAXA: 3e-5}
# The hamiltonian full width: HAM_WARM_SWEEPS sweeps without the move,
# HAM_WINDOWS adaptation windows from HAM_EPS0, then the timed sweeps.
# The hamiltonian tutorial's run and marginal-likelihood take HAM_ITERATIONS
# iterations (the main path's 20, cut to 10 to keep the smoke inside its
# limit).
HAM_ITERATIONS = 10
HAM_WARM_SWEEPS = 20
HAM_WINDOWS = 3
HAM_EPS0 = 1e-3
HAM_FULL_SWEEPS = 10
# MC3: CHAINS chains as MC3_GROUPS groups of 4 temperatures.  The kernels
# phase tempers the prior by a ladder of rung gaps MC3_DT (inside the
# [0.01, 2] the run's tuning keeps them in).  The tutorial runs the CLI's
# --profile schedule (60 burn-in iterations) and ITERATIONS, then continues
# CONTINUE_ITERATIONS; the full width burns in MC3_WINDOWS windows of
# MC3_WINDOW iterations (two sweeps and a swap a chunk), then samples
# MC3_ITERATIONS and continues CONTINUE_ITERATIONS; with the NUTS move the
# last MC3_HAM_WINDOWS of the windows are slow ones (the move adapts
# there).  At 1000 taxa, this early in a run, the chains still climb and
# the swaps sort each group's states by their log posterior, so the
# coldest pair swaps rarely: 2e-4 to 1.1e-3 of its attempts on an H100
# (PERF.md), 2,500 nats between slots 0 and 1 where tempering by 1% would
# leave about 25 at equilibrium.  Windows of one chunk (2 iterations) take
# the rungs to the 0.01 floor in 32 iterations, and the swap rates are
# checked on the counts pooled over the phase's four runs.
MC3_GROUPS = CHAINS // 4
MC3_DT = (0.3, 0.6, 1.0)
MC3_WINDOW = 2
MC3_WINDOWS = 16
MC3_ITERATIONS = 20
MC3_HAM_WINDOWS = 2
# The optional moves (--bold-contra, --bold-factor, --fiber-slide,
# --fiber-de) of the two optional phases and the kernel checks.  The fiber
# DE's decisions against its plain version's: the log prior of a whole
# state is a sum of 3 N terms in another order, so a decision may differ
# where |log u - dlp| < LP_REL (1 + |log prior|).
BOLD_P, BOLD_FACTOR, FIBER_SLIDE, FIBER_DE = 0.4, 8.0, 1.0, 2.0
OPT_FLAGS = ("--bold-contra", str(BOLD_P), "--bold-factor", str(BOLD_FACTOR), "--fiber-slide",
             str(FIBER_SLIDE), "--fiber-de", str(FIBER_DE))
OPT_MC3_ITERATIONS = 4
# Back-to-back calls per kernel timing; PLAIN_REPS for a plain version that
# launches thousands of kernels a call.
REPS = 20
PLAIN_REPS = 3
# Bytes read before each call of a kernel timed with the L2 flushed: several
# times the H100's 50 MB L2.
FLUSH_BYTES = 256 << 20

# float32 tolerances of kernel against plain version, both on the card.
# K1: same formulas and CUDA math library, products rounded one by one
# (-fmad=false); only summation order (braces) differs.
K1_RTOL, K1_ATOL = 1e-5, 1e-5
# K1's birth-death block against the plain version in float64 on the same
# (float32) state: K1 evaluates it in double and rounds once, so the
# near-critical cancellation of a float32 evaluation (about +2 per inner
# node) must not show.
K1_BD_F64_RTOL, K1_BD_F64_ATOL = 1e-6, 1e-6
# K2: sums of up to D products in another order than cuBLAS: the error is
# bounded relative to the largest output.
K2_REL = 1e-5
# K3: the term sum is reduced in another order; accept decisions may
# differ only where |log u - log alpha| is below this.
K3_TIE = 1e-4
# K4, K5: the scans' sums run in another order.  Per chain, decisions agree
# up to the first that differs, which must be a tie (|log u - log alpha| <
# SCAN_TIE); dq agrees up to there within SCAN_REL of the chain's |dq|.
# K5's range step is replayed through the plain step with the kernel's
# proposals (within CONTRA_REL (1 + |x|) of the plain ones from the same
# draws) and decisions: heights, rates and terms must then be bitwise
# equal, d, z and q within SCAN_REL of their largest |value|.
SCAN_TIE = 1e-4
SCAN_REL = 1e-5
# K6 (both modes): the same formulas built with -fmad=false, but CUDA's
# normal CDF, its inverse and log in place of PyTorch's, so a proposal may
# differ from the plain one in its last bits, and a term that divides by a
# short branch amplifies that.  So: the kernel's proposals are within
# CONTRA_REL (1 + |h|) of the plain version's from the same uniforms;
# replayed through the plain version, they give the kernel's log proposal
# ratios within SCAN_TIE (1 + |lq|), its decisions except at ties (|log u -
# log alpha| < SCAN_TIE) and, with the ties taken as the kernel took them,
# its heights, rates and terms within CONTRA_REL (1 + |x|) and its accept
# counts, on every chain and ticket; the kernel keeps every branch distance
# (h_parent - h) r within CONTRA_REL (|h_parent| + |h|) |r| of its old value
# (the subtraction cancels on short branches); and its terms equal a fresh
# evaluation of its own new state within CONTRA_REL (1 + |term|).
CONTRA_REL = 1e-5
# The glob kernels' truncated-normal proposals x = mean + s ndtri(p), with p
# in float32 from each side's own normal CDF: a few ulps of p move x by
# dx/dp = s / phi(z) each, which is large in the tails.  They must be within
# CONTRA_REL (1 + |x|) + PROP_ULPS float32 eps dx/dp of the plain version's
# from the same draws (the gamma families' factor is one product: exact).
PROP_ULPS = 8
# The main path's carried log posterior (float32, updated at every accept)
# against a direct float32 evaluation of its final state by the plain
# versions: relative to the largest |log posterior|.
LP_REL = 1e-5
# That direct float32 evaluation against a float64 one of the same state:
# float32 rounding of the clock terms, the sums and the whitened residual,
# relative to the largest |log posterior|.  A biased float32 formula (the
# near-critical birth-death cancellation added about +2 per inner node,
# over 100 at 136 taxa) fails it.
LP_F64_REL = 1e-4
# A1-A3 (float64, -fmad=false) against their plain versions on the same
# inputs: A1's A and U, A2's Qs and A3's Z and U bitwise; A3's r^2 and s^2
# are the same terms summed in another order: within ADMM_SUM_REL relative.
ADMM_SUM_REL = 1e-12
# The whole ADMM by the kernels against the plain route on the card: the
# same iterations and zero pattern, Theta and W within ADMM_THETA_TOL.
ADMM_THETA_TOL = 1e-10
ADMM_NAMES = ("admm_shift", "admm_eig_scale", "admm_update")

KERNELS = (
    ("prior_terms", "mcmcdate_tpu_torch/kernels/csrc/prior_terms.cu",
     "mcmcdate_tpu/models/dating.py:131"),
    ("whiten", "mcmcdate_tpu_torch/kernels/csrc/whiten.cu",
     "mcmcdate_tpu/models/dating.py:209"),
    ("ticket_prologue", "mcmcdate_tpu_torch/kernels/csrc/ticket_step.cu",
     "mcmcdate_tpu/engine/proposals.py:388"),
    ("accept_select", "mcmcdate_tpu_torch/kernels/csrc/accept_select.cu",
     "mcmcdate_tpu/engine/mh.py:194"),
    ("ticket_scan", "mcmcdate_tpu_torch/kernels/csrc/ticket_step.cu",
     "mcmcdate_tpu/engine/mh.py:194"),
    ("point_lik_prologue", "mcmcdate_tpu_torch/kernels/csrc/point_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1324"),
    ("point_scan", "mcmcdate_tpu_torch/kernels/csrc/point_scan.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1511"),
    ("point_lik_epilogue", "mcmcdate_tpu_torch/kernels/csrc/point_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1536"),
    ("range_lik_prologue", "mcmcdate_tpu_torch/kernels/csrc/range_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1695"),
    ("range_scan", "mcmcdate_tpu_torch/kernels/csrc/range_scan.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1860"),
    ("range_lik_epilogue", "mcmcdate_tpu_torch/kernels/csrc/range_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1876"),
    ("contra_slide", "mcmcdate_tpu_torch/kernels/csrc/contra_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1223"),
    *((f"contra_range_{rb}", "mcmcdate_tpu_torch/kernels/csrc/contra_step.cu",
       "mcmcdate_tpu/engine/fast_sweep.py:1566") for rb in (16, 64, 256)),
    ("glob_scan", "mcmcdate_tpu_torch/kernels/csrc/glob_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1195"),
    ("glob_dense_prologue", "mcmcdate_tpu_torch/kernels/csrc/glob_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:949"),
    ("glob_dense_epilogue", "mcmcdate_tpu_torch/kernels/csrc/glob_step.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1195"),
    ("admm_shift", "mcmcdate_tpu_torch/kernels/csrc/glasso_admm.cu",
     "mcmcdate_tpu/utils/glasso.py:110"),
    ("admm_eig_scale", "mcmcdate_tpu_torch/kernels/csrc/glasso_admm.cu",
     "mcmcdate_tpu/utils/glasso.py:111"),
    ("admm_update", "mcmcdate_tpu_torch/kernels/csrc/glasso_admm.cu",
     "mcmcdate_tpu/utils/glasso.py:125"),
    ("cascade_seed", "mcmcdate_tpu_torch/kernels/csrc/cascade_seed.cu",
     "mcmcdate_tpu/engine/stepping_stone.py:85"),
    ("band_matmul", "mcmcdate_tpu_torch/kernels/csrc/band_matmul.cu",
     "mcmcdate_tpu/ops/banded.py:209"),
    ("band_matmul_t", "mcmcdate_tpu_torch/kernels/csrc/band_matmul.cu",
     "mcmcdate_tpu/ops/banded.py:235"),
    ("band_rows_add", "mcmcdate_tpu_torch/kernels/csrc/band_matmul.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:1554"),
    ("nuts_leapfrog_prologue", "mcmcdate_tpu_torch/kernels/csrc/nuts_step.cu",
     "mcmcdate_tpu/engine/hmc.py:118"),
    ("nuts_leapfrog_epilogue", "mcmcdate_tpu_torch/kernels/csrc/nuts_step.cu",
     "mcmcdate_tpu/engine/hmc.py:183"),
    ("nuts_merge", "mcmcdate_tpu_torch/kernels/csrc/nuts_step.cu",
     "mcmcdate_tpu/engine/hmc.py:246"),
    ("mc3_swap", "mcmcdate_tpu_torch/kernels/csrc/mc3_swap.cu",
     "mcmcdate_tpu/engine/mc3.py:37"),
    ("fiber_slide", "mcmcdate_tpu_torch/kernels/csrc/fiber_slide.cu",
     "mcmcdate_tpu/engine/fast_sweep.py:2016"),
    ("fiber_de", "mcmcdate_tpu_torch/kernels/csrc/fiber_de.cu",
     "mcmcdate_tpu/engine/ensemble.py:81"),
)
OPT_NAMES = ("fiber_slide", "fiber_de", "contra_range_bold", "glob_scan_bold")
BAND_NAMES = ("band_matmul", "band_matmul_t", "band_rows_add")
NUTS_NAMES = ("nuts_leapfrog_prologue", "nuts_leapfrog_epilogue", "nuts_merge")
# The kernels whose decisions take the likelihood temperature beta (all of
# them, with K6 and the K4 and K5 epilogues' own decisions, take the prior
# temperature beta_prior: check_tempered gives each record a ``tempered``
# key).
BETA_KERNELS = ("accept_select", "ticket_scan", "point_scan", "range_scan", "glob_scan",
                "glob_dense_epilogue")
# The path whose launches a kernel's record reports (the main path's but
# for A1-A3, which only the 1000-taxon sparse prepare runs).
RECORD_PATH = {**{k: "sparse_full_width" for k in ADMM_NAMES},
               **{k: "banded_full_width" for k in BAND_NAMES},
               **{k: "hamiltonian_full_width" for k in NUTS_NAMES},
               "cascade_seed": "marginal_likelihood", "mc3_swap": "mc3_full_width",
               "fiber_slide": "optional_tutorial", "fiber_de": "optional_tutorial"}
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s, and float32 and float64 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
# float64 on the tensor cores (cuBLAS's DGEMM: the ADMM's product).
PEAK_F64_TC = 67e12
# The profiler names of T3's two kernels (a warp per ticket in light runs, a
# CTA per chain for a heavy ticket).
T3_KERNELS = ("ticket_run_kernel", "ticket_scan_kernel")


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    """Raise with ``msg`` (or ``msg()``, built only on failure) unless
    ``cond``."""
    if not cond:
        raise SmokeError(msg() if callable(msg) else msg)


def log(msg):
    print(msg, flush=True)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from mcmcdate_tpu_torch.kernels import build

    path, seconds, built = build.build()
    log(f"[build] {os.path.relpath(path, HERE)}: "
        f"{'built in %.1f s' % seconds if built else 'already built'}")
    build.library()


def _sync():
    import torch

    torch.cuda.synchronize()


def _device_ms(fn, only=None, reps=REPS, flush=False):
    """Device milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, from the profiler's device intervals: kernels, memcpy, memset (only
    those whose name contains ``only``, or one of them, where given), so
    the host's enqueue gaps do not count.  ``flush``: a read of
    ``FLUSH_BYTES`` before each call evicts its inputs from the L2, as the
    sweep's other work does between two calls (needs ``only``, which
    leaves the read out).  A profile that recorded none of those intervals
    (the profiler's device trace can come back empty) is taken again, up
    to twice; if all three are empty, the time comes from CUDA events
    around ``reps`` calls (which also count the gaps between launches),
    and the log says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (only,) if isinstance(only, str) else only
    buf = None
    if flush:
        check(names is not None, "a flushed timing needs the kernel's name")
        buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    fn()
    _sync()
    for _ in range(3):
        # Device activity only, read from the profiler's events (no host
        # operators, no trace file: a plain version's thousands of launches
        # made those the most of the kernel checks' time).
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush:
                    buf.sum()
                fn()
            _sync()
        dev = [e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and (names is None or any(o in e.name() for o in names))]
        if dev:
            return sum(dev) / 1e6 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms = 0.0
    for _ in range(reps if flush else 1):
        if flush:
            buf.sum()
        start.record()
        for _ in range(1 if flush else reps):
            fn()
        end.record()
        _sync()
        ms += start.elapsed_time(end) / reps
    log(f"[timing] the profiler recorded no device time for {names or 'the call'} three times: "
        f"{ms:.4f} ms a call from CUDA events")
    return ms


def _event_ms(fn, reps=REPS):
    """Milliseconds per call of ``fn`` by CUDA events around ``reps``
    back-to-back calls after a warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def _bound(nbytes, ops, ops64=0):
    """``(bound_ms, bound_by)``: the larger of the byte time and the
    operation time (``ops`` float32 and ``ops64`` float64 operations) at the
    card's published peaks."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / PEAK_F32 + ops64 / PEAK_F64) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(err, ms, plain_ms, nbytes, ops, library_ms=None, ops64=0):
    bound_ms, bound_by = _bound(nbytes, ops, ops64)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _perturbed(model, batch, seed):
    """A state near ``batch`` with varied scalars and rates per chain."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    C, N = batch.heights.shape
    dev = batch.heights.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    h = batch.heights * t(rng.uniform(0.97, 1.0, size=(C, 1)))
    h[:, 0] = 1.0
    h[:, torch.as_tensor(model.topo.is_leaf, device=dev)] = 0.0
    birth = rng.uniform(0.2, 3.0, C)
    death = rng.uniform(0.0, 3.0, C)
    death[::7] = birth[::7] + rng.uniform(-5e-7, 5e-7, len(birth[::7]))  # near-critical
    # Just above the near-critical threshold: a few float32 ulps apart.
    death[3::7] = (birth[3::7].astype(np.float32) + np.float32(1.5e-6)).astype(np.float64)
    rate_var = rng.uniform(0.02, 1.5, C)
    rate_var[::5] = 1e-3  # gamma shape > 100: the Stirling branch
    return batch.replace(
        heights=h.contiguous(), rates=t(rng.gamma(5.0, 0.2, size=(C, N))),
        birth=t(birth), death=t(death), height=t(rng.uniform(0.5, 3.0, C)),
        rate_mean=t(rng.uniform(0.5, 2.0, C)), rate_var=t(rate_var),
    )


def _node_priors(topo):
    """A few calibrations, one constraint and one brace on inner nodes."""
    import numpy as np

    from mcmcdate_tpu_torch.ops.node_priors import BraceSet, CalibrationSet, ConstraintSet

    inner = [int(i) for i in topo.inner_nodes if i != 0]
    cal = CalibrationSet(
        node=np.asarray([0, inner[0], inner[1]], np.int32),
        lower=np.asarray([1.0, 0.4, 0.0]), lower_pm=np.asarray([0.01, 0.02, 1.0]),
        upper=np.asarray([2.0, np.inf, 0.3]), upper_pm=np.asarray([0.01, 1.0, 0.05]),
        names=("root", "a", "b"))
    con = ConstraintSet(young=np.asarray([inner[-1]], np.int32),
                        old=np.asarray([inner[-2]], np.int32), pm=np.asarray([0.01]))
    br = BraceSet(node=np.asarray([[inner[2], inner[-3], -1]], np.int32),
                  sd=np.asarray([0.02]))
    return cal, con, br


_MODELS = {}


def _model(n_taxa):
    """The synthetic full-MVN model and chain batch of a shape (built once)."""
    from mcmcdate_tpu_torch import synthetic

    if n_taxa not in _MODELS:
        _MODELS[n_taxa] = synthetic.build(n_taxa, CHAINS, device="cuda")
    return _MODELS[n_taxa]


def _k1_agree(name, m, s):
    """K1 against its plain version on state ``s``: finiteness, NaNs and
    infinities equal, finite terms within K1_ATOL + K1_RTOL |term|.
    Returns K1's terms and the largest difference."""
    import torch

    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms, prior_terms_plain

    k = prior_terms(m, s)
    p = prior_terms_plain(m, s)
    _sync()
    fin = torch.isfinite(p)
    check(torch.equal(fin, torch.isfinite(k)), f"{name}: finiteness differs")
    check(torch.equal(torch.isnan(p), torch.isnan(k)), f"{name}: NaNs differ")
    check(torch.equal(p[~fin & ~torch.isnan(p)], k[~fin & ~torch.isnan(k)]),
          f"{name}: infinite terms differ")
    err = (k[fin] - p[fin]).abs()
    bad = err > K1_ATOL + K1_RTOL * p[fin].abs()
    check(not bool(bad.any()), lambda: f"{name}: max error {float(err.max()):.3g}")
    return k, float(err.max())


def check_prior_terms(n_taxa):
    import dataclasses

    import torch

    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms_plain
    from mcmcdate_tpu_torch.ops import clocks

    model, batch = _model(n_taxa)
    cal, con, br = _node_priors(model.topo)
    worst = 0.0
    for clock in clocks.MODELS:
        m = dataclasses.replace(model, clock=clock, calibrations=cal, constraints=con,
                                braces=br, mean_root_height=1.5)
        s = _perturbed(m, batch, 1)
        k, err = _k1_agree(f"prior_terms {clock}", m, s)
        worst = max(worst, err)
        bd = slice(4, 4 + m.topo.n + 1)
        p64 = prior_terms_plain(dataclasses.replace(m, dtype=torch.float64),
                                s.to(dtype=torch.float64))[:, bd]
        kb = k[:, bd].double()
        fin = torch.isfinite(p64)
        check(torch.equal(fin, torch.isfinite(kb)), f"prior_terms {clock}: finiteness vs f64")
        err = (kb[fin] - p64[fin]).abs()
        bad = err > K1_BD_F64_ATOL + K1_BD_F64_RTOL * p64[fin].abs()
        check(not bool(bad.any()), lambda:
              f"prior_terms {clock}: birth-death terms off float64 by {float(err.max()):.3g}")
    s = _perturbed(model, batch, 2)
    return {"prior_terms": _k1_record(worst, model, s)}


def _k1_record(err, model, s):
    """K1's record on state ``s``: flushed device time (K1 runs at a
    carry's start, after other work), the plain version's, and the bound.
    Bytes: heights and rates, five scalars per chain, parent and leaf flags
    in; the term vector out.  Operations: the birth-death terms in double,
    about 100 per node and chain (two D/E evaluations of an inner node, one
    of a leaf, each exp or log counted as 10), as T1's record counts them;
    the clock terms in float, about 40."""
    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms, prior_terms_plain

    ms = _device_ms(lambda: prior_terms(model, s), only="prior_terms_kernel", flush=True)
    plain_ms = _device_ms(lambda: prior_terms_plain(model, s), reps=5)
    C, N = s.heights.shape
    T = sum(model.term_block_sizes)
    nbytes = 4 * (2 * C * N + 5 * C) + 5 * N + 4 * C * T
    return _record(err, ms, plain_ms, nbytes, 40 * C * N, ops64=100 * C * N)


def check_whiten(n_taxa):
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels.whiten import range_rows, whiten, whiten_plain
    from mcmcdate_tpu_torch.ops.heights import distances_internal

    model, batch = _model(n_taxa)
    s = _perturbed(model, batch, 3)
    D = model.likelihood.dim
    L, mu = model.chol_internal_t, model.mu_internal_t
    d = distances_internal(s, model.topo).contiguous()
    y, _ = whiten_plain(d, L, sub=mu)
    d2 = (d * (1.0 + 0.01 * torch.randn_like(d))).contiguous()
    table = P.build_proposal_table(model.topo, model.braces, False)
    p_gather = int(next(i for i, c in enumerate(table.d_class) if c == P.DC_GATHER))
    gather = torch.as_tensor(table.didx[p_gather], dtype=torch.int32, device=d.device)
    lo = next((int(table.d_lo[i]) for i, c in enumerate(table.d_class) if c == P.DC_B1024), 1)
    rng1024 = torch.as_tensor(range_rows(lo, 1024, D), dtype=torch.int32, device=d.device)
    delta = (d2 - d).contiguous()
    cases = {
        "full": dict(x=d, sub=mu),
        "full-delta": dict(x=d2, sub=mu, y=y, minus_y=True),
        "gather": dict(x=delta, rows=gather, y=y),
        "range1024": dict(x=delta, rows=rng1024, y=y),
    }
    worst = 0.0
    for name, kw in cases.items():
        dk, rk = whiten(L=L, **kw)
        dp, rp = whiten_plain(L=L, **kw)
        _sync()
        for what, a, b in (("dy", dk, dp), ("reduction", rk, rp)):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(err <= K2_REL * max(scale, 1.0),
                  f"whiten {name} {what}: max error {err:.3g} at scale {scale:.3g}")
            worst = max(worst, err)
    kw = cases["full-delta"]
    ms = _device_ms(lambda: whiten(L=L, **kw), only="whiten")
    plain_ms = _device_ms(lambda: whiten_plain(L=L, **kw))
    # One PyTorch call of the same product, cuBLAS float32 (TF32 off).
    xs = (d2 - mu).contiguous()
    library_ms = _device_ms(lambda: torch.matmul(xs, L))
    C = d.shape[0]
    # Bytes: x, y, mu and L in, dy and the per-chain sum out.  Operations:
    # the [C, D] x [D, D] product.
    nbytes = 4 * (2 * C * D + D + D * D) + 4 * (C * D + C)
    return {"whiten": _record(worst, ms, plain_ms, nbytes, 2 * C * D * D, library_ms)}


def _mh_copy(carry):
    """A copy of an MHKernel carry."""
    from mcmcdate_tpu_torch.engine.mh import Carry
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    def cl(t):
        return None if t is None else t.clone()

    return Carry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                 carry.terms.clone(), cl(carry.d), cl(carry.y), carry.acc.clone(),
                 carry.nbad.clone(), beta=carry.beta, beta_prior=carry.beta_prior)


def _mh_same(name, worst, ck, cp, logu, la_p, accept):
    """A kernel carry against the plain replay's at the kernel's proposals
    and decisions: decisions differ from the replay's log alpha only at ties
    (K3_TIE); heights, rates, scalars, terms, d and the accept and bad-term
    counts bitwise equal; y within SCAN_REL of its scale.  Returns the
    number of tie decisions."""
    import torch

    from mcmcdate_tpu_torch.models.state import FIELDS

    differ = (logu < la_p) != accept
    gap = (logu - la_p).abs()[differ]
    check(bool((gap < K3_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    for f in FIELDS:
        a, b = getattr(ck.batch, f), getattr(cp.batch, f)
        check(_same(a, b), lambda: f"{name} {f}: {int((a != b).sum())} values differ from the "
              f"replay's")
    check(_same(ck.terms, cp.terms), lambda: f"{name} terms: "
          f"{int((ck.terms != cp.terms).sum())} values differ from the replay's")
    check(torch.equal(ck.acc, cp.acc) and torch.equal(ck.nbad, cp.nbad),
          f"{name}: accept or bad-term counts differ")
    if ck.d is not None:
        check(torch.equal(ck.d, cp.d), f"{name}: d differs from the replay's")
        _within(name, worst, "y", ck.y, cp.y, SCAN_REL, max(1.0, float(cp.y.abs().max())))
    return int(differ.sum())


def _prop_lim(rec_prop, dx_dp):
    import torch

    return CONTRA_REL * (1 + rec_prop.abs()) + PROP_ULPS * torch.finfo(torch.float32).eps * dx_dp


def _ticket_one_agree(name, tk, carry, tuning, p, draw, u, worst):
    """T1, K2 where the row's class needs it, and K3 on one ticket of row
    ``p`` against the plain versions on copies of ``carry``: the kernel's
    proposal against the plain one from the same draw; replayed at it
    (and at var_tree's rate mean), T1's invalid flags and new terms
    bitwise, d_pr, lmhg and lj within SCAN_TIE (1 + |x|), delta exact; then
    K3 against the plain epilogue with its decisions (_mh_same)."""
    import torch

    from mcmcdate_tpu_torch.kernels.accept_select import accept_select, accept_select_plain
    from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, ticket_prologue, \
        ticket_prologue_plain

    tt = tk.tt
    dr = TicketDraws.single(p, draw, u)
    ck, cp = _mh_copy(carry), _mh_copy(carry)
    pro = ticket_prologue(tt, ck, tuning, dr, 0)
    k = {f: getattr(pro, f).clone() for f in ("prop", "lmhg", "lj", "d_pr", "invalid")}
    mean = None if pro.mean is None else pro.mean.clone()
    tix, rows = tt.tix(p), tt.rows(p)
    tn = pro.tn[:, tix].clone()
    has_rows = tt.lik and (rows is None or rows.numel() > 0)
    dl = None if not has_rows else (pro.delta if rows is None else pro.delta[:, rows]).clone()
    pp = ticket_prologue_plain(tt, cp, tuning, p, draw)
    dx = torch.zeros_like(pp.prop) if pp.dx_dp is None else pp.dx_dp
    err = (k["prop"] - pp.prop).abs()
    check(bool((err <= _prop_lim(pp.prop, dx)).all()),
          lambda: f"{name}: proposals off the plain version's by {float(err.max()):.3g}")
    worst["prop"] = max(worst.get("prop", 0.0), float(err.max()))
    pp = ticket_prologue_plain(tt, cp, tuning, p, draw, given=k["prop"], given_mean=mean)
    check(torch.equal(k["invalid"], pp.invalid), f"{name}: invalid flags differ")
    check(_same(tn, pp.tn[:, tix]), f"{name}: new terms differ from the replay's")
    for f in ("d_pr", "lmhg", "lj"):
        _within(name, worst, f, k[f], getattr(pp, f), SCAN_TIE)
    if dl is not None:
        check(torch.equal(dl, pp.delta if rows is None else pp.delta[:, rows]),
              f"{name}: delta differs from the replay's")
    dy, d_lik = tk._k2(ck, p, pro)
    ak = accept_select(tt, ck, tuning, dr, 0, pro, dy, d_lik)
    ap, la_p = accept_select_plain(tt, cp, p, pp, torch.where(ak, 0.0, math.nan), dy, d_lik)
    check(torch.equal(ak, ap),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    return _mh_same(name, worst, ck, cp, torch.log(u), la_p, ak), int(ak.sum())


def _ticket_scan_agree(name, tk, carry, tuning, dr, worst):
    """T3 over the whole of ``dr`` (a run) against ``ticket_scan_plain``
    replayed at its proposals, rate means and decisions, on copies of
    ``carry`` (see _ticket_one_agree).  Returns ``(ties, accepts, total)``."""
    import torch

    from mcmcdate_tpu_torch.kernels.ticket_step import ticket_scan, ticket_scan_plain

    tt = tk.tt
    ck, cp = _mh_copy(carry), _mh_copy(carry)
    out = ticket_scan(tt, ck, tuning, dr, 0, dr.n, out=True)
    _sync()
    rec = ticket_scan_plain(tt, cp, tuning, dr._replace(u_acc=torch.where(out.accept, 0.0,
                                                                              math.nan)),
                            0, dr.n, given=dict(prop=out.prop, mean=out.mean))
    check(torch.equal(rec.accept, out.accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    err = (out.prop - rec.prop).abs()
    check(bool((err <= _prop_lim(rec.prop, rec.dx_dp)).all()),
          lambda: f"{name}: proposals off the plain version's by {float(err.max()):.3g}")
    worst["prop"] = max(worst.get("prop", 0.0), float(err.max()))
    ties = _mh_same(name, worst, ck, cp, torch.log(dr.u_acc), rec.log_alpha, out.accept)
    return ties, int(out.accept.sum()), out.accept.numel()


def _ticket_work(tt, order):
    """What a run of ``order``'s tickets must move and compute per chain:
    ``(floats, bd terms, other terms)``: per ticket its draws, the state
    entries it writes (old kept, new written), its term entries (old in,
    new out), its class rows (d, y in; d, y out) and the flags."""
    N = tt.N
    floats = bd = other = 0
    o_bd, o_ck = 4, 4 + N + 1
    for p in order:
        p = int(p)
        tix = tt.tix(p).cpu().numpy()
        n_bd = int(((tix >= o_bd) & (tix < o_ck)).sum())
        fl = int(tt.cols["fields"][p])
        nodes = (N * ((fl & 1) + ((fl >> 1) & 1))
                 + (int(tt.n_off[p + 1] - tt.n_off[p])) * (((fl >> 7) & 1) + ((fl >> 8) & 1)))
        rows = tt.rows(p)
        nr = tt.D if rows is None else int(rows.numel())
        floats += 3 + 2 * nodes + 2 * len(tix) + 4 * nr + 5
        bd += n_bd
        other += len(tix) - n_bd
    return floats, bd, other


def check_ticket(n_taxa):
    """T1 ticket_prologue, K3 accept_select and T3 ticket_scan on the
    calibrated synthetic model (all 17 proposal kinds) under its full MVN:
    T1 and K3 on one ticket of every kind and every (class, kind) pair
    against their plain versions; T3 on a 256-ticket run of the table's
    non-breaking tickets against ticket_scan_plain.  The records time T1
    and K3 on the pulley (FastSweeps' T1/K2/K3 ticket) and T3 on one run of
    the FastSweeps leftovers' non-breaking tickets, in a drawn order (the
    main path's run shape)."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import mh as M, proposals as P
    from mcmcdate_tpu_torch.kernels.accept_select import accept_select, accept_select_plain
    from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, ticket_prologue, \
        ticket_prologue_plain, ticket_scan, ticket_scan_plain
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    fs, fcarry, tuning, gen = _glob_fast(n_taxa)
    tk = M.MHKernel(fs.model, fs.table)
    tt = tk.tt
    carry = tk.init_carry(fcarry.batch)
    C = carry.terms.shape[0]

    def draw_of(p):
        return (standard_gamma(float(tt.table.par[p]) / tuning[:, p], gen) if tt.gamma[p]
                else torch.rand(C, generator=gen, device="cuda"))

    rows = {}
    for p, kind in enumerate(tt.table.kind):
        rows.setdefault((int(kind), int(tt.table.aux[p]) if kind == P.K_SCALE_SCALAR else 0), p)
        rows.setdefault((int(kind), int(tt.d_class[p]), "dc"), p)
    check({k[0] for k in rows} == set(range(P.N_KINDS)), "the table lacks a proposal kind")
    worst, ties, n_acc = {}, 0, 0
    for p in sorted(set(rows.values())):
        t, a = _ticket_one_agree(f"ticket {tt.table.names[p]} at {n_taxa} taxa", tk, carry,
                                 tuning, p, draw_of(p), torch.rand(C, generator=gen,
                                                                   device="cuda"), worst)
        ties, n_acc = ties + t, n_acc + a
    check(n_acc > 0, "the ticket checks accepted nothing")
    log(f"[kernels] ticket_prologue + accept_select at {n_taxa} taxa: {len(set(rows.values()))} "
        f"rows (every kind and class), {n_acc} accepts, {ties} tie decisions differ from the "
        f"replay; largest differences {json.dumps(worst)}")
    tickets = np.asarray(tt.table.tickets)
    ok = np.asarray([not tt.breaks(int(p)) for p in tickets])
    order = np.random.default_rng(n_taxa).choice(tickets[ok], 256).astype(np.int32)
    w3 = {}
    ties, n_acc, n_all = _ticket_scan_agree(f"ticket_scan at {n_taxa} taxa", tk, carry, tuning,
                                            tk.draws(order, tuning, gen), w3)
    check(0 < n_acc < n_all, f"ticket_scan accepted {n_acc} of {n_all}: not a mixed case")
    log(f"[kernels] ticket_scan at {n_taxa} taxa: 256 tickets that do not break a run, {n_acc} "
        f"accepts of {n_all}, {ties} tie decisions differ from the replay, state, terms and d "
        f"bitwise equal to it; largest differences {json.dumps(w3)}")

    # T1 and K3 on the pulley.
    N, T, D = tt.N, tt.T, tt.D
    nn = T - 4 - 2 * (N + 1)
    p = int(np.nonzero(tt.table.kind == P.K_PULLEY_ULTRA)[0][0])
    draw, u = draw_of(p), torch.rand(C, generator=gen, device="cuda")
    dr = TicketDraws.single(p, draw, u)
    c1 = _mh_copy(carry)
    ms1 = _device_ms(lambda: ticket_prologue(tt, c1, tuning, dr, 0), only="ticket_prologue_kernel")
    c2 = _mh_copy(carry)
    plain1 = _device_ms(lambda: ticket_prologue_plain(tt, c2, tuning, p, draw))
    c3 = _mh_copy(carry)
    pro = ticket_prologue(tt, c3, tuning, dr, 0)
    dy, d_lik = tk._k2(c3, p, pro)
    acc0 = accept_select(tt, _mh_copy(c3), tuning, dr, 0, pro, dy, d_lik)
    ms3 = _device_ms(lambda: accept_select(tt, c3, tuning, dr, 0, pro, dy, d_lik),
                     only="accept_select_kernel", flush=True)
    c4 = _mh_copy(carry)
    pp = ticket_prologue_plain(tt, c4, tuning, p, draw)
    plain3 = _device_ms(lambda: accept_select_plain(tt, c4, p, pp, u, dy, d_lik))
    # T1.  Bytes: per chain heights and rates in, the new heights and the
    # old ones out, the bd, ck and nd blocks in and out, d in and d_new and
    # delta out, a few scalars.  Operations: the birth-death block in
    # double (about 100 per node, each exp or log counted as 10), the clock
    # block (about 40 per node) and the distances (4 per row).
    nb1 = 4 * C * (4 * N + 2 * (2 * (N + 1) + nn) + 3 * D + 12)
    # K3.  Bytes: per chain dy and y and five values in; for the accepted
    # chains the three blocks and d_new in, terms, d and y out; for the
    # rejected ones the old heights in and out.  Operations: y + dy.
    na = int(acc0.sum())
    nb3 = 4 * C * (2 * D + 6) + 4 * na * (2 * (2 * (N + 1) + nn) + 3 * D) + 4 * (C - na) * 2 * N
    # T3 on the FastSweeps leftovers' non-breaking tickets of one sweep.
    sk = fs.seq_kern
    rows_t = torch.as_tensor(fs.plan.seq_rows.astype(np.int64), device="cuda")
    stun = tuning[:, rows_t].contiguous()
    seq = np.asarray(sk.table.tickets)
    seq = seq[np.random.default_rng(1).permutation(len(seq))]
    seq = np.asarray([q for q in seq if not sk.tt.breaks(int(q))], np.int32)
    scarry = M.Carry(carry.batch, carry.terms, carry.d, carry.y,
                     torch.zeros((C, sk.table.n_proposals), dtype=torch.int32, device="cuda"),
                     carry.nbad)
    sdr = sk.draws(seq, stun, gen)
    c5, c6 = _mh_copy(scarry), _mh_copy(scarry)
    ms5 = _device_ms(lambda: ticket_scan(sk.tt, c5, stun, sdr, 0, len(seq)), only=T3_KERNELS)
    plain5 = _device_ms(lambda: ticket_scan_plain(sk.tt, c6, stun, sdr, 0, len(seq)), reps=1)
    fl5, bd5, ot5 = _ticket_work(sk.tt, seq)
    log(f"[kernels] ticket_scan at {n_taxa} taxa: the leftovers' run of {len(seq)} tickets "
        f"(of {len(sk.table.tickets)} leftovers a sweep): {ms5:.4f} ms, "
        f"{ms5 / len(seq) * 1e3:.2f} us a ticket")
    return {
        "ticket_prologue": _record(max(worst.get("prop", 0.0), worst.get("d_pr", 0.0)), ms1,
                                   plain1, nb1, C * (40 * (N + 1) + 4 * D + 100),
                                   ops64=100 * C * N),
        "accept_select": _record(worst.get("y", 0.0), ms3, plain3, nb3, 4 * C * D),
        "ticket_scan": _record(max(w3.get("prop", 0.0), w3.get("y", 0.0)), ms5, plain5,
                               4 * C * fl5, C * (40 * ot5 + 100 * len(seq)), ops64=100 * C * bd5),
    }


_FAST = {}


def _fast(n_taxa):
    """FastSweeps on the synthetic model of a shape, with a carry (z and q
    filled), a tuning and a generator (built once)."""
    import torch

    from mcmcdate_tpu_torch.engine import fast_sweep, proposals as P

    if n_taxa not in _FAST:
        model, batch = _model(n_taxa)
        table = P.build_proposal_table(model.topo, model.braces, False)
        fs = fast_sweep.FastSweeps(model, table)
        carry = fs.init_carry(batch)
        carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
        gen = torch.Generator(device="cuda").manual_seed(n_taxa)
        tuning = 0.3 + 2.7 * torch.rand((CHAINS, table.n_proposals), generator=gen,
                                        device="cuda")
        _FAST[n_taxa] = fs, carry, tuning, gen
    return _FAST[n_taxa]


def _draws(fs, sx, tuning, gen, gamma):
    import torch

    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    n = sx["rows"].shape[0]
    draw = (standard_gamma(sx["sd"] / tuning[:, sx["rows"]], gen) if gamma
            else torch.rand((CHAINS, n), generator=gen, device="cuda"))
    return draw, torch.rand((CHAINS, n), generator=gen, device="cuda")


def _same(a, b):
    """Bitwise equal, NaN where NaN."""
    import torch

    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])


def _copy_carry(carry):
    from mcmcdate_tpu_torch.engine.fast_sweep import FastCarry
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    return FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                     carry.terms.clone(), carry.d.clone(), carry.z.clone(), carry.q.clone(),
                     carry.acc.clone(), beta=carry.beta, beta_prior=carry.beta_prior)


def _step_recorded(names, step):
    """Run ``step()`` with the kernel wrappers ``names`` of FastSweeps'
    module recorded: ``{name: output, name + "_args": arguments}``."""
    from mcmcdate_tpu_torch.engine import fast_sweep

    rec = {}
    real = {k: getattr(fast_sweep, k) for k in names}

    def recorder(key):
        def run(*args):
            rec[key + "_args"] = args
            rec[key] = real[key](*args)
            return rec[key]
        return run

    for k in real:
        setattr(fast_sweep, k, recorder(k))
    try:
        out = step()
    finally:
        for k, fn in real.items():
            setattr(fast_sweep, k, fn)
    _sync()
    return rec, out


def _within(name, worst, what, a, b, rel, scale=None):
    """``a`` within ``rel (1 + |b|)`` of ``b`` (or ``rel scale``; a tensor of
    scales, such as each chain's, holds every entry to the smallest) where
    ``b`` is finite, with the same finite entries; the largest difference
    goes to ``worst[what]``."""
    import torch

    fin = torch.isfinite(b)
    check(torch.equal(fin, torch.isfinite(a)), f"{name} {what}: finiteness differs")
    err = (a - b).abs()[fin]
    worst[what] = float(err.max()) if err.numel() else 0.0
    if scale is None:
        lim = rel * (1 + b.abs()[fin])
    else:
        lim = rel * float(scale.min() if torch.is_tensor(scale) else scale)
    check(bool((err <= lim).all()),
          lambda: f"{name} {what}: off the plain version by {worst[what]:.3g}")


K4_NAMES = ("point_lik_prologue", "point_scan", "point_lik_epilogue")


def _point_step_agree(name, fs, carry, tuning, kind, sx, draw, u):
    """K4's likelihood point step (prologue, point_scan, epilogue and the z
    product, as ``FastSweeps.point_lik_step`` runs them) on one step,
    against its plain version, on copies of ``carry``: the kernel's
    proposals against the plain version's from the same draws; the kernel's
    proposals replayed through ``point_lik_given``, with every decision
    taken as the kernel took it, whose log alpha must give the kernel's
    decisions except at ties, whose new terms must equal the prologue's
    and whose heights, rates and terms after the step must equal the
    kernels' bitwise, with d, z and q within SCAN_REL of their scale and dq
    within SCAN_REL of the smallest chain's (each chain's largest |dq|, at
    least 1).  Returns ``(worst differences, recorded kernel inputs and
    outputs)``."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import point_step as K

    model = fs.model
    branch = kind == P.K_SCALE_BRANCH_RATE
    leaf = model.topo.is_leaf_t
    ck, cr = _copy_carry(carry), _copy_carry(carry)
    rec, accept = _step_recorded(K4_NAMES, lambda: fs.point_lik_step(kind, ck, tuning, sx,
                                                                      draw, u))
    check(len(rec) == 6, f"{name}: the step did not run all three kernels")
    pro = rec["point_lik_prologue"]
    dq = rec["point_scan"][1]
    worst = {}
    pp = K.point_lik_prologue_plain(branch, carry.batch, carry.terms, carry.d, carry.z, tuning,
                                    sx, leaf, fs.pos_t, model.clock, draw)
    _within(name, worst, "prop", pro.prop, pp.prop, CONTRA_REL)
    forced = torch.where(accept, 0.0, math.nan)
    acc_r, pr, dq_r = K.point_lik_given(branch, cr.batch, cr.terms, cr.d, cr.z, cr.q, cr.acc,
                                        tuning, sx, leaf, fs.pos_t, model.clock, pro.prop, forced)
    check(torch.equal(acc_r, accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    _within(name, worst, "lq", pro.lq, pr.lq, SCAN_TIE)
    check(_same(pro.tn, pr.tn), lambda: f"{name}: {int((pro.tn != pr.tn).sum())} new terms "
          f"differ from the replay's")
    for what in ("delta", "zG", "d_pr"):
        _within(name, worst, what, getattr(pro, what), getattr(pr, what), SCAN_REL)
    la = torch.nan_to_num(pr.d_pr - 0.5 * dq_r + pr.lmhg, nan=-math.inf)
    differ = (torch.log(u) < la) != accept
    gap = (torch.log(u) - la).abs()[differ]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    _within(name, worst, "dq", dq, dq_r, SCAN_REL, dq_r.abs().amax(1, keepdim=True).clamp(min=1.0))
    for what, a, b in (("heights", ck.batch.heights, cr.batch.heights),
                       ("rates", ck.batch.rates, cr.batch.rates), ("terms", ck.terms, cr.terms)):
        check(_same(a, b), lambda: f"{name} {what}: {int((a != b).sum())} values differ from "
              f"the replay's")
    for what, a, b in (("d", ck.d, cr.d), ("z", ck.z, cr.z), ("q", ck.q, cr.q)):
        _within(name, worst, what, a, b, SCAN_REL, max(1.0, float(b.abs().max())))
    check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
    check(0 < int(accept.sum()) < accept.numel(), f"{name}: not a mixed case")
    log(f"[kernels] {name}: B={accept.shape[1]}, KD={sx['d_rows'].shape[1]}, "
        f"{int(accept.sum())} accepts, {int(differ.sum())} tie decisions differ from the "
        f"replay, heights, rates and terms bitwise equal to it; largest differences "
        f"{json.dumps(worst)}")
    return worst, rec


def _kernel_names(fn, reps=3, wrappers=()):
    """The device kernels (and copies) that ``reps`` calls of ``fn`` launch,
    by name, and the kernel launches the host made (profiler).  The
    profiler's device trace can come back empty, in some processes every
    time: after six empty ones, where the host's launches were recorded,
    the names are those of the port's ``wrappers`` (names of ``_wrappers``)
    whose launch counts rose in the last ``reps`` calls, each as often as
    it rose, provided they account for every launch the host made (so no
    other kernel ran); else it fails."""
    from torch.profiler import ProfilerActivity, profile

    wr = _wrappers()
    fn()
    _sync()
    for attempt in range(6):
        if attempt:
            time.sleep(1.0)  # the profiler's device trace can come back empty: take it again
        before = {k: wr[k].launches for k in wrappers}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            _sync()
        events = prof.events()
        names = [e.name for e in events if e.device_type.name == "CUDA"]
        launches = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                  "cuLaunchKernelEx") for e in events)
        if names:
            return names, launches
    rose = {k: wr[k].launches - before[k] for k in wrappers}
    check(launches > 0 and sum(rose.values()) == launches,
          f"the profiler recorded no device kernel in six traces, and the host's {launches} "
          f"launches are not those of {rose}")
    log(f"[timing] the profiler recorded no device kernel in six traces: the host's {launches} "
        f"launches are the wrappers' {rose}")
    return [f"{k}_kernel" for k, n in rose.items() for _ in range(n)], launches


def _k4_bytes(sx, C, accept, branch, with_z):
    """The bytes K4's prologue and epilogue must move on one step, each
    value once.  Prologue: per chain and ticket the draw and tuning in, the
    node's and its parent's heights, the node's rate and, for a slide, each
    child's height and rate, the old terms at the real term rows and d (and
    z) at the distance rows; prop, lq, d_pr, lmhg, the new terms, delta
    (and zG) out; five scalars per chain; the step's plan records and
    calibration bounds.  Epilogue: accept per chain and ticket in, dacc
    out; per accepted ticket dq, prop, its new terms at the real rows and
    its deltas in, its height or rate and terms out (a rate also in), d in
    and out at its rows, its accept count in and out; q in and out; the
    step's node, rows, valid flags, term and distance rows.  Returns
    ``(prologue, epilogue)``."""
    B, KC = sx["ch"].shape
    KT, KD = sx["t_rows"].shape[1], sx["d_rows"].shape[1]
    KN = sx["cal_lo"].shape[-1]
    kc = 0 if branch else KC
    real_t = (sx["t_rows"] >= 0).sum(1)  # [B]
    nz = 2 if with_z else 1
    pro = (4 * C * (B * (2 + (2 + kc) + (1 + kc) + nz * KD) + int(real_t.sum()))
           + 4 * C * B * (4 + KT + nz * KD) + 20 * C + 4 * sx["kplan"].numel() + 16 * B * KN)
    n_acc = int(accept.sum())
    acc_t = int((accept * real_t[None, :]).sum())
    epi = (C * B + 4 * C * B * KD
           + 4 * n_acc * (2 + KD + (2 if branch else 1) + 2 * KD + 2) + 8 * acc_t + 8 * C
           + 4 * B * (2 + KT + KD) + B)
    return pro, epi


def _k4_proposal_misses(fs, carry, tuning, sx, seeds=8):
    """K4's slide proposals against the plain version's from the same
    uniforms, over ``seeds`` generators' draws: the largest miss as a share
    of CONTRA_REL (1 + |x|) and in float32 eps times dx/dp (the inverse
    CDF's sensitivity, s sqrt(2 pi) exp(z^2 / 2)), and how many miss
    CONTRA_REL (1 + |x|).  Logged only: the check in _point_step_agree is
    the one that holds."""
    import torch

    from mcmcdate_tpu_torch.kernels import point_step as K

    model = fs.model
    leaf = model.topo.is_leaf_t
    eps = torch.finfo(torch.float32).eps
    worst = dict(share=0.0, eps_dx_dp=0.0, misses=0, pairs=0)
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
        draw = torch.rand((CHAINS, sx["rows"].shape[0]), generator=gen, device="cuda")
        args = (False, carry.batch, carry.terms, carry.d, carry.z, tuning, sx, leaf, fs.pos_t,
                model.clock, draw)
        pk = K.point_lik_prologue(*args).prop
        pp = K.point_lik_prologue_plain(*args).prop
        s = tuning[:, sx["rows"]] * sx["sd"]
        zz = (pp - carry.batch.heights[:, sx["node"]]) / s
        dx_dp = s * math.sqrt(2.0 * math.pi) * torch.exp(0.5 * zz * zz)
        err = (pk - pp).abs()
        lim = CONTRA_REL * (1 + pp.abs())
        worst["share"] = max(worst["share"], float((err / lim).max()))
        worst["eps_dx_dp"] = max(worst["eps_dx_dp"], float((err / (eps * dx_dp)).max()))
        worst["misses"] += int((err > lim).sum())
        worst["pairs"] += err.numel()
    return worst


def check_point_step(n_taxa):
    """K4 (prologue, point_scan, epilogue) on the planner's first (largest)
    step of both likelihood point kinds; one point_lik_step launches only
    the three K4 kernels and the z product; the records time the node
    slides' step (KD = 3, the widest), its prologue and epilogue with the
    L2 flushed before each call, and the same two kernels on the branch
    kind's step (KD = 1: ``branch`` in each record).  At the full width,
    K4's slide proposals against the plain ones over 8 seeds' draws, logged
    (_k4_proposal_misses).  Returns a record per kernel."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import point_step as K
    from mcmcdate_tpu_torch.kernels.point_scan import SUB, point_scan, point_scan_plain

    fs, carry, tuning, gen = _fast(n_taxa)
    model = fs.model
    leaf = model.topo.is_leaf_t
    worst = {}
    k4 = {}
    for kind in (P.K_SCALE_BRANCH_RATE, P.K_SLIDE_NODE_ULTRA):
        branch = kind == P.K_SCALE_BRANCH_RATE
        sx = fs.spec_t[kind][0]
        draw, u = _draws(fs, sx, tuning, gen, branch)
        w, rec = _point_step_agree(f"point step kind {kind} at {n_taxa} taxa", fs, carry,
                                   tuning, kind, sx, draw, u)
        for k, v in w.items():
            worst[k] = max(worst.get(k, 0.0), v)
        # The prologue and epilogue alone, flushed, and their plain versions.
        pro, (accept, dq) = rec["point_lik_prologue"], rec["point_scan"]
        c1, c2 = _copy_carry(carry), _copy_carry(carry)
        pargs = (branch, c1.batch, c1.terms, c1.d, c1.z, tuning, sx, leaf, fs.pos_t,
                 model.clock, draw)
        eargs = (branch, c2.batch, c2.terms, c2.d, c2.q, c2.acc, sx, pro, accept, dq)
        ms = {"prologue": _device_ms(lambda: K.point_lik_prologue(*pargs),
                                     only="point_lik_prologue_kernel", flush=True),
              "epilogue": _device_ms(lambda: K.point_lik_epilogue(*eargs),
                                     only="point_lik_epilogue_kernel", flush=True)}
        plain = {"prologue": _device_ms(lambda: K.point_lik_prologue_plain(*pargs)),
                 "epilogue": _device_ms(lambda: K.point_lik_epilogue_plain(*eargs))}
        pro_bytes, epi_bytes = _k4_bytes(sx, CHAINS, accept, branch, True)
        KC = 0 if branch else sx["ch"].shape[1]
        C, B = accept.shape
        KD = sx["d_rows"].shape[1]
        # Operations: about 100 for the proposal and 120 per node whose
        # birth-death (in double) and clock terms it evaluates (1 + KC),
        # special functions counted as 10.
        k4[kind] = dict(
            sx=sx, draw=draw, u=u, rec=rec, pargs=pargs, eargs=eargs, ms=ms, plain=plain,
            pro=_record(max(w["prop"], w["lq"]), ms["prologue"], plain["prologue"], pro_bytes,
                        C * B * (100 + 120 * (1 + KC))),
            epi=_record(max(w["d"], w["z"], w["q"]), ms["epilogue"], plain["epilogue"],
                        epi_bytes, int(accept.sum()) * KD))
        log(f"[kernels] point step kind {kind} at {n_taxa} taxa (B={B}, KD={KD}), flushed: "
            f"prologue {ms['prologue']:.4f} ms (plain {plain['prologue']:.4f}, bound "
            f"{k4[kind]['pro']['bound_ms']:.4f} {k4[kind]['pro']['bound_by']}), epilogue "
            f"{ms['epilogue']:.4f} ms (plain {plain['epilogue']:.4f}, bound "
            f"{k4[kind]['epi']['bound_ms']:.4f} {k4[kind]['epi']['bound_by']})")
    kind = P.K_SLIDE_NODE_ULTRA
    branch = False
    sl = k4[kind]
    sx, draw, u, rec = sl["sx"], sl["draw"], sl["u"], sl["rec"]
    # The slide step: its kernels alone, and what one step launches.
    # Three steps: only the three K4 kernels and the product's one or two
    # gemm kernels, each K4 kernel in at least two of the profiler's
    # records (it may drop one), at most 5 launches a step.
    c0 = _copy_carry(carry)
    names, launches = _kernel_names(lambda: fs.point_lik_step(kind, c0, tuning, sx, draw, u))
    k4n = {k: sum(k + "_kernel" in n for n in names) for k in K4_NAMES}
    other = sorted({n for n in names if not any(k + "_kernel" in n for k in K4_NAMES)})
    check(all(v >= 2 for v in k4n.values()) and all("gemm" in n.lower() for n in other)
          and launches <= 15,
          f"three point_lik_steps launched {launches} kernels: {k4n} and {other}, not the three "
          f"K4 kernels and the product alone")
    log(f"[kernels] three point_lik_steps at {n_taxa} taxa: {launches} launches, K4 {k4n}, "
        f"other {other}")
    accept = rec["point_scan"][0]
    c3 = _copy_carry(carry)
    pargs = sl["pargs"]
    sargs = rec["point_scan_args"]

    def plain_step():
        p = K.point_lik_prologue_plain(*pargs)
        a, q_ = point_scan_plain(p.delta, p.zG, sx["Pblk"], p.d_pr, p.lmhg, u)
        _, dacc = K.point_lik_epilogue_plain(branch, c3.batch, c3.terms, c3.d, c3.q, c3.acc, sx,
                                             p, a, q_)
        c3.z.addmm_(dacc, sx["Prow"])

    ms = {"scan": _device_ms(lambda: point_scan(*sargs), only="point_scan_kernel"),
          "step": _device_ms(lambda: fs.point_lik_step(kind, c3, tuning, sx, draw, u))}
    # The plain scan launches a few kernels a ticket (about 5,000 a call at
    # 1000 taxa): PLAIN_REPS calls, not REPS, keep the profile short.
    plain = {"scan": _device_ms(lambda: point_scan_plain(*sargs), reps=PLAIN_REPS),
             "step": _device_ms(plain_step, reps=PLAIN_REPS)}
    C, B = accept.shape
    KD = sx["d_rows"].shape[1]
    F = B * KD
    log(f"[kernels] point step kind {kind} at {n_taxa} taxa (B={B}, KD={KD}): device time per "
        f"step: the step {ms['step']:.4f} ms (plain {plain['step']:.4f} ms), of which "
        f"prologue {sl['ms']['prologue']:.4f} (flushed), point_scan {ms['scan']:.4f}, epilogue "
        f"{sl['ms']['epilogue']:.4f} ms (flushed)")
    # point_scan.  Bytes: deltas, zG, Pblk, d_pr, lmhg and u in; accept and
    # dq out.  Operations: dq0, the cross terms of each sub-block and, for
    # this run's accepts, the zG updates of the later columns (at the plain
    # version's sub-blocks of SUB tickets).
    scan_ops = C * B * (2 * KD + 2 * KD * KD)
    for lo in range(0, B, SUB):
        sn = min(SUB, B - lo)
        scan_ops += C * sn * (sn - 1) * KD * KD
        if lo + sn < B:
            scan_ops += int(accept[:, lo:lo + sn].sum()) * 2 * KD * (F - (lo + sn) * KD)
    scan_bytes = 4 * (2 * C * F + F * F + 3 * C * B) + 5 * C * B
    if n_taxa == BENCH_TAXA:
        miss = _k4_proposal_misses(fs, carry, tuning, sx)
        log(f"[kernels] K4 slide proposals against the plain ones at {n_taxa} taxa, 8 seeds' "
            f"draws on the first step (B={B}): largest miss {miss['share']:.4g} of CONTRA_REL "
            f"(1 + |x|), {miss['eps_dx_dp']:.4g} float32 eps dx/dp; {miss['misses']} of "
            f"{miss['pairs']} pairs miss CONTRA_REL (1 + |x|)")
    br = k4[P.K_SCALE_BRANCH_RATE]
    return {
        "point_lik_prologue": dict(sl["pro"], branch=br["pro"]),
        "point_scan": _record(worst["dq"], ms["scan"], plain["scan"], scan_bytes, scan_ops),
        "point_lik_epilogue": dict(sl["epi"], branch=br["epi"]),
    }


def check_prior_only_steps(n_taxa):
    """Without a likelihood, K4's and K5's prologue and epilogue kernels
    (the epilogue taking the decisions) on the first step of both point
    kinds and the first block of every bucket of both likelihood range
    kinds, through ``FastSweeps.point_lik_step`` / ``range_lik_step``: each
    launches its prologue and epilogue once and nothing else of the port;
    the plain prologue replayed at the kernels' proposals gives their
    decisions except at ties, and the plain epilogue on their decisions
    gives their heights, rates and terms bitwise, d within SCAN_REL of its
    scale and the same accept counts; q stays as it was.  No records: the
    kernels' come from their likelihood checks."""
    return _prior_only(n_taxa)


def _prior_only(n_taxa, beta_prior=None):
    """check_prior_only_steps, or with ``beta_prior`` (each chain's prior
    temperature, which the epilogues' decisions take) the tempered check:
    no launch count; the epilogue timed flushed with ones and with
    ``beta_prior`` in turns on the first slide step and the largest range
    block, ``{"point_lik_epilogue": ..., "range_lik_epilogue": ...}``."""
    import dataclasses

    import torch

    from mcmcdate_tpu_torch.engine import fast_sweep, proposals as P
    from mcmcdate_tpu_torch.kernels import point_step as KP, range_step as KR
    from mcmcdate_tpu_torch.ops import mvn

    _, _, tuning, gen = _fast(n_taxa)
    model, batch = _model(n_taxa)
    model = dataclasses.replace(model, likelihood=mvn.LikelihoodData.none())
    fs = fast_sweep.FastSweeps(model, P.build_proposal_table(model.topo, model.braces, False))
    carry = fs.init_carry(batch)
    leaf = model.topo.is_leaf_t
    cases = [("point", k, k == P.K_SCALE_BRANCH_RATE, fs.spec_t[k][0])
             for k in (P.K_SCALE_BRANCH_RATE, P.K_SLIDE_NODE_ULTRA)]
    cases += [("range", k, k == P.K_SCALE_SUBTREE_RATE, steps[0])
              for (k, _), steps in fs.range_t.items() if k != P.K_SCALE_SUBTREES_CONTRA]
    carry.beta_prior = beta_prior
    worst, out, timed = {}, {}, {}
    for step, kind, flag, sx in cases:
        name = (f"{step} step kind {kind} without a likelihood at {n_taxa} taxa"
                + ("" if beta_prior is None else ", tempered"))
        draw, u = _draws(fs, sx, tuning, gen, flag)
        ck, cr = _copy_carry(carry), _copy_carry(carry)
        run = fs.point_lik_step if step == "point" else fs.range_lik_step
        counts, accept = _counted(lambda: run(kind, ck, tuning, sx, draw, u))
        # A range block's mask is its bucket's buffer, which the steps below
        # overwrite.
        accept = accept.clone()
        _sync()
        launched = {k: n for k, n in counts.items() if n}
        want = {f"{step}_lik_prologue": 1, f"{step}_lik_epilogue": 1}
        check(launched == want, f"{name}: launched {launched}, not {want}")
        if step == "point" and kind == P.K_SLIDE_NODE_ULTRA or step == "range" and (
                step not in timed or sx["rows"].shape[0] > timed[step][2]["rows"].shape[0]):
            timed[step] = (kind, flag, sx, draw, u)
        if step == "point":
            pro = KP.point_lik_prologue(flag, cr.batch, cr.terms, cr.d, None, tuning, sx, leaf,
                                        fs.pos_t, model.clock, draw)
            pr = KP.point_lik_prologue_given(flag, cr.batch, cr.terms, cr.d, None, tuning, sx,
                                             leaf, fs.pos_t, model.clock, pro.prop)
            epilogue_plain = KP.point_lik_epilogue_plain
        else:
            pro = KR.range_lik_prologue(flag, cr.batch, cr.terms, cr.d, None, tuning, sx, leaf,
                                        model.clock, draw)
            pr = KR.range_lik_prologue_given(flag, cr.batch, cr.terms, cr.d, None, tuning, sx,
                                             leaf, model.clock, pro.prop)
            epilogue_plain = KR.range_lik_epilogue_plain
        bp = 1.0 if beta_prior is None else beta_prior[:, None]
        la = torch.nan_to_num(bp * pr.d_pr + pr.lmhg, nan=-math.inf)
        differ = ((torch.log(u) < la) & sx["valid"]) != accept
        gap = (torch.log(u) - la).abs()[differ]
        check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions "
              f"differ beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
        epilogue_plain(flag, cr.batch, cr.terms, cr.d, cr.q, cr.acc, sx, pr, accept, None)
        for what, a, b in (("heights", ck.batch.heights, cr.batch.heights),
                           ("rates", ck.batch.rates, cr.batch.rates), ("terms", ck.terms, cr.terms)):
            check(_same(a, b), lambda: f"{name} {what}: {int((a != b).sum())} values differ "
                  f"from the replay's")
        _within(name, worst, "d", ck.d, cr.d, SCAN_REL, max(1.0, float(cr.d.abs().max())))
        check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
        check(torch.equal(ck.q, carry.q), f"{name}: q changed")
        check(0 < int(accept.sum()) < int(sx["valid"].sum()) * accept.shape[0],
              f"{name}: not a mixed case")
        if beta_prior is not None:
            log(f"[tempered] {name}: {int(accept.sum())} accepts, {int(differ.sum())} tie "
                f"decisions differ from the replay, heights, rates and terms bitwise equal to "
                f"it; d within {worst['d']:.3g}")
            continue
        # Three steps launch the prologue and epilogue kernels alone.
        names, n_launch = _kernel_names(lambda: run(kind, ck, tuning, sx, draw, u),
                                        wrappers=(f"{step}_lik_prologue", f"{step}_lik_epilogue"))
        other = sorted({n for n in names if f"{step}_lik_" not in n})
        check(not other and n_launch <= 6,
              f"{name}: three steps launched {n_launch} kernels, {other} besides {step}_lik_*")
        log(f"[kernels] {name}: {int(accept.sum())} accepts, {int(differ.sum())} tie decisions "
            f"differ from the replay, heights, rates and terms bitwise equal to it; d within "
            f"{worst['d']:.3g}; three steps launched {n_launch} kernels")
    if beta_prior is None:
        return out
    for step, (kind, flag, sx, draw, u) in timed.items():
        K = KP if step == "point" else KR
        h = _copy_carry(carry)
        extra = (fs.pos_t,) if step == "point" else ()
        pro = getattr(K, f"{step}_lik_prologue")(flag, h.batch, h.terms, h.d, None, tuning, sx,
                                                 leaf, *extra, model.clock, draw)
        epilogue = getattr(K, f"{step}_lik_epilogue")
        ms = _in_turns(lambda: epilogue(flag, h.batch, h.terms, h.d, h.q, h.acc, sx, pro, None,
                                        None, u, h.beta_prior),
                       h, None, beta_prior, f"{step}_lik_epilogue_kernel")
        out[f"{step}_lik_epilogue"] = dict(max_abs_err=worst["d"], ms=ms[1], ms_untempered=ms[0])
        log(f"[tempered] {step}_lik_epilogue without a likelihood at {n_taxa} taxa, kind {kind}, "
            f"{sx['rows'].shape[0]} tickets, flushed: {ms[1]:.4f} ms with the prior ladder, "
            f"{ms[0]:.4f} untempered")
    return out


def _range_step_agree(name, fs, carry, tuning, kind, sx, draw, u):
    """K5's likelihood range step (prologue, range_scan, epilogue and the z
    product, as ``FastSweeps.range_lik_step`` runs them) on one block,
    against its plain version, on copies of ``carry``: the kernel's
    proposals against the plain version's from the same draws; the kernel's
    proposals replayed through ``range_lik_given``, with every decision
    taken as the kernel took it, whose log alpha must give the kernel's
    decisions except at ties and whose heights, rates and terms must equal
    the kernel's bitwise, with d, z and q within SCAN_REL of their scale
    and dq within SCAN_REL of the smallest chain's (each chain's largest
    |dq|, at least 1).  Returns ``(worst differences, recorded kernel inputs
    and outputs, copy)``."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import range_step as K

    model = fs.model
    rate = kind == P.K_SCALE_SUBTREE_RATE
    leaf = model.topo.is_leaf_t

    def copy():
        return _copy_carry(carry)

    ck, cr = copy(), copy()
    rec, accept = _step_recorded(("range_lik_prologue", "range_scan", "range_lik_epilogue"),
                                 lambda: fs.range_lik_step(kind, ck, tuning, sx, draw, u))
    check(len(rec) == 6, f"{name}: the step did not run all three kernels")
    pro = rec["range_lik_prologue"]
    dq = rec["range_scan"][1]
    worst = {}

    def within(what, a, b, rel, scale=None):
        _within(name, worst, what, a, b, rel, scale)

    # The proposals, from the same draws.
    pp = K.range_lik_prologue_plain(rate, carry.batch, carry.terms, carry.d, carry.z, tuning,
                                    sx, leaf, model.clock, draw)
    within("prop", pro.prop, pp.prop, CONTRA_REL)
    # The kernel's proposals through the plain step, each decision forced
    # as the kernel took it (log 0 < any finite log alpha; log NaN < nothing).
    forced = torch.where(accept, 0.0, math.nan)
    acc_r, pr, dq_r = K.range_lik_given(rate, cr.batch, cr.terms, cr.d, cr.z, cr.q, cr.acc,
                                        tuning, sx, leaf, model.clock, pro.prop, forced)
    check(torch.equal(acc_r, accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    within("lq", pro.lq, pr.lq, SCAN_TIE)
    la = torch.nan_to_num(pr.d_pr - 0.5 * dq_r + pr.lmhg, nan=-math.inf)
    differ = (torch.log(u) < la) != accept
    gap = (torch.log(u) - la).abs()[differ]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    within("dq", dq, dq_r, SCAN_REL, dq_r.abs().amax(1, keepdim=True).clamp(min=1.0))
    for what, a, b in (("heights", ck.batch.heights, cr.batch.heights),
                       ("rates", ck.batch.rates, cr.batch.rates), ("terms", ck.terms, cr.terms)):
        check(_same(a, b), lambda: f"{name} {what}: {int((a != b).sum())} values differ from "
              f"the replay's")
    for what, a, b in (("d", ck.d, cr.d), ("z", ck.z, cr.z), ("q", ck.q, cr.q)):
        within(what, a, b, SCAN_REL, max(1.0, float(b.abs().max())))
    check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
    check(0 < int(accept.sum()) < accept.numel(), f"{name}: not a mixed case")
    log(f"[kernels] {name}: S={accept.shape[1]}, RB={sx['own'].shape[1]}, "
        f"{int(accept.sum())} accepts, {int(differ.sum())} tie decisions differ from the "
        f"replay, heights, rates and terms bitwise equal to it; largest differences "
        f"{json.dumps(worst)}")
    return worst, rec, copy


def _k5_records(fs, kind, sx, tuning, draw, u, copy, worst):
    """K5's prologue and epilogue on one block, each timed against its
    plain version on the same inputs, as records; the prologue's and
    epilogue's outputs come from the block's ``RangeWork``, as on the main
    path.  Also returns the inputs, for the record block's scan and step
    timings."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import range_step as K
    from mcmcdate_tpu_torch.kernels.range_scan import range_scan

    rate = kind == P.K_SCALE_SUBTREE_RATE
    model = fs.model
    leaf = model.topo.is_leaf_t
    c1, c2 = copy(), copy()
    pargs = (rate, c1.batch, c1.terms, c1.d, c1.z, tuning, sx, leaf, model.clock, draw)
    pro = K.range_lik_prologue(*pargs)
    accept, dq = range_scan(pro.g, pro.zg, sx["Q"], pro.coef, pro.d_pr, pro.lmhg, u)
    eargs = (rate, c2.batch, c2.terms, c2.d, c2.q, c2.acc, sx, pro, accept, dq)
    ms_p = _device_ms(lambda: K.range_lik_prologue(*pargs), only="range_lik_prologue_kernel")
    ms_e = _device_ms(lambda: K.range_lik_epilogue(*eargs), only="range_lik_epilogue_kernel")
    plain_p = _device_ms(lambda: K.range_lik_prologue_plain(*pargs))
    plain_e = _device_ms(lambda: K.range_lik_epilogue_plain(*eargs))
    C, S = accept.shape
    RB = sx["own"].shape[1]
    F = S * RB
    KN = pro.cal_new.shape[-1]
    R = int((sx["own"] >= 0).sum())                     # real rows of the block
    rows_acc = int((accept.to(torch.int64) * (sx["own"] >= 0).sum(1)).sum())
    # Prologue.  Bytes, each value once: per chain and ticket the draw, the
    # tuning, the height above the subtree root (the truncation bound, or
    # the root branch's parent) and five outputs; per chain and real row its
    # height (a non-root row's parent is a row of the same subtree), rate, d
    # (not on an ultrametric root row, whose direction is its height), z and
    # its terms in (two, one for the rate kind), and its g, zg, new value
    # and terms out (five, four for the rate kind); g and zg per chain and
    # pad slot; per real calibration slot its term in and out (its height
    # is a row's); five scalars per chain; the block's plan (16 bytes a row
    # slot, 36 a ticket).  Operations: per ticket the proposal (100, special
    # functions counted as 10); per real row the clock term and the row's
    # products (20) and, for the ultrametric kind, its birth-death term in
    # double (100, under ops64, as check_glob counts it).
    roots = 0 if rate else int(((sx["own"] == sx["node"][:, None]) & (sx["own"] >= 0)).sum())
    n_cal = int((sx["cal_t_rows"] >= 0).sum()) if KN else 0
    row_floats = 9 if rate else 11
    pro_bytes = (4 * C * S * 8 + 4 * C * (R * row_floats - roots) + 8 * C * (F - R)
                 + 4 * C * n_cal * 2 + 20 * C + 16 * F + 36 * S)
    pro_ops, pro_ops64 = C * (20 * R + 100 * S), (0 if rate else 100 * C * R)
    # Epilogue.  Bytes: accept, coef and dq per chain and ticket in; dacc
    # out; per accepted row g and its new values in (three, two for the
    # rate kind), its height or rate and terms out, d in and out; q in and
    # out; the block's plan.  Operations: one product per accepted row.
    epi_bytes = (9 * C * S + 4 * C * F + (28 if rate else 36) * rows_acc + 8 * C + 16 * F
                 + 36 * S)
    recs = {
        "range_lik_prologue": _record(max(worst["prop"], worst["lq"]), ms_p, plain_p,
                                      pro_bytes, pro_ops, ops64=pro_ops64),
        "range_lik_epilogue": _record(max(worst["d"], worst["z"], worst["q"]), ms_e, plain_e,
                                      epi_bytes, rows_acc),
    }
    return recs, dict(S=S, RB=RB, F=F, R=R, KN=KN, pargs=pargs, accept=accept, dq=dq, pro=pro,
                      c2=c2)


def check_range_step(n_taxa):
    """K5 (prologue, range_scan, epilogue) on the first block of every
    bucket of both likelihood range kinds, each replayed against the plain
    step; the prologue and epilogue timed on each of those blocks (logged
    with the block's real rows R and slots S RB); the records keep the
    block with the most tickets, which also times range_scan and the whole
    step.  Returns a record per kernel."""
    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.kernels import range_step as K
    from mcmcdate_tpu_torch.kernels.range_scan import range_scan, range_scan_plain

    fs, carry, tuning, gen = _fast(n_taxa)
    worst, timed = {}, None
    for (kind, rb), steps in fs.range_t.items():
        if kind == P.K_SCALE_SUBTREES_CONTRA:
            continue
        sx = steps[0]
        draw, u = _draws(fs, sx, tuning, gen, kind == P.K_SCALE_SUBTREE_RATE)
        name = f"range step kind {kind} rows {rb} at {n_taxa} taxa"
        w, rec, copy = _range_step_agree(name, fs, carry, tuning, kind, sx, draw, u)
        for k, v in w.items():
            worst[k] = max(worst.get(k, 0.0), v)
        recs, info = _k5_records(fs, kind, sx, tuning, draw, u, copy, w)
        for k, r in recs.items():
            log(f"[kernels] {k} kind {kind} rows {rb} at {n_taxa} taxa (S={info['S']}, "
                f"RB={info['RB']}, R={info['R']} of S RB={info['F']}): kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if timed is None or info["S"] > timed[2]["S"]:
            timed = kind, sx, info, recs, draw, u, rec
    kind, sx, info, recs, draw, u, rec = timed
    rate = kind == P.K_SCALE_SUBTREE_RATE
    c3 = _copy_carry(carry)
    sargs = rec["range_scan_args"]
    pargs, pro, c2 = info["pargs"], info["pro"], info["c2"]

    def plain_step():
        p = K.range_lik_prologue_plain(*pargs)
        a, q_ = range_scan_plain(p.g, p.zg, sx["Q"], p.coef, p.d_pr, p.lmhg, u)
        _, dacc = K.range_lik_epilogue_plain(rate, c3.batch, c3.terms, c3.d, c3.q, c3.acc, sx,
                                             p, a, q_)
        c3.z.addmm_(dacc, sx["Prow"])

    ms = {"scan": _device_ms(lambda: range_scan(*sargs), only="range_scan_kernel"),
          "step": _device_ms(lambda: fs.range_lik_step(kind, c3, tuning, sx, draw, u))}
    plain = {"scan": _device_ms(lambda: range_scan_plain(*sargs)), "step": _device_ms(plain_step)}
    C, S, RB, F = pro.prop.shape[0], info["S"], info["RB"], info["F"]
    log(f"[kernels] range step kind {kind} at {n_taxa} taxa (S={S}, RB={RB}): device time per "
        f"block: the step {ms['step']:.4f} ms (plain {plain['step']:.4f} ms), of which "
        f"prologue {recs['range_lik_prologue']['ms']:.4f}, range_scan {ms['scan']:.4f}, "
        f"epilogue {recs['range_lik_epilogue']['ms']:.4f} ms")
    # range_scan.  Bytes: g, zg, Q and the four [C, S] inputs in; accept
    # and dq out.  Operations: the Gram blocks a <= b (2 RB^2 + 2 RB each),
    # v, the scan.
    scan_ops = C * (S * (S + 1) // 2 * (2 * RB * RB + 2 * RB) + 2 * S * RB + 3 * S * S)
    scan_bytes = 4 * (2 * C * F + F * F + 4 * C * S) + 5 * C * S
    return {
        "range_lik_prologue": dict(recs["range_lik_prologue"],
                                   max_abs_err=max(worst["prop"], worst["lq"])),
        "range_scan": _record(worst["dq"], ms["scan"], plain["scan"], scan_bytes, scan_ops),
        "range_lik_epilogue": dict(recs["range_lik_epilogue"],
                                   max_abs_err=max(worst["d"], worst["z"], worst["q"])),
    }


def _contra_agree(name, mode, fs, carry, tuning, sx, u_prop, u_acc, bold=None):
    """K6 in one mode on one step against its plain version, on copies of
    ``carry``: the kernel's proposals against the plain version's from the
    same uniforms; the kernel's proposals replayed through the plain
    version, whose decisions must equal the kernel's except at ties and,
    with the ties taken as the kernel took them, whose heights, rates, terms
    and accept counts must equal the kernel's on every chain and ticket;
    distance invariance; and the kernel's terms against a fresh evaluation
    of its own new state.  Returns ``(worst differences, kernel output,
    run(fn))``, where ``run`` calls the kernel or its plain version on that
    function's own copy.  The decisions take ``carry.beta_prior``; ``bold``
    (range mode: ``u_bold``, ``bold_p``, ``bold_factor``) adds the bold
    mixture to every call."""
    import torch

    from mcmcdate_tpu_torch.engine.fast_sweep import FastCarry
    from mcmcdate_tpu_torch.kernels import contra_step as K
    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms_plain
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    kernel, plain, given = getattr(K, f"contra_{mode}"), getattr(K, f"contra_{mode}_plain"), \
        getattr(K, f"contra_{mode}_given")
    model = fs.model
    leaf = model.topo.is_leaf_t

    def copy():
        return FastCarry(State(**{f: getattr(carry.batch, f).clone() for f in FIELDS}),
                         carry.terms.clone(), carry.d, carry.z, carry.q, carry.acc.clone(),
                         beta_prior=carry.beta_prior)

    bold = bold or {}

    def run(fn, c):
        return fn(c.batch, c.terms, c.acc, tuning, sx, leaf, model.clock, u_prop, u_acc,
                  c.beta_prior, **bold)

    def lengths(st):
        """Branch distances (time x rate) and the size of the products they
        are the difference of: a short branch loses bits to cancellation."""
        par, nr = model.topo.parent_t, model.topo.non_root_t
        h, r = st.heights, st.rates
        return (torch.where(nr, (h[:, par] - h) * r, 0.0),
                torch.where(nr, (h[:, par].abs() + h.abs()) * r.abs(), 0.0))

    worst = {}

    def within(what, a, b, rel):
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a)), f"{name} {what}: finiteness differs")
        inf = ~fin & ~torch.isnan(b)
        check(torch.equal(a[inf], b[inf]), f"{name} {what}: infinite values differ")
        err = (a - b).abs()[fin]
        worst[what] = float(err.max()) if err.numel() else 0.0
        check(bool((err <= rel * (1 + b.abs()[fin])).all()),
              lambda: f"{name} {what}: off the plain version by {worst[what]:.3g}")

    ck, cp, cr = copy(), copy(), copy()
    ok, op = run(kernel, ck), run(plain, cp)
    _sync()
    valid = sx["valid"].expand_as(ok.accept)
    # The proposals, drawn from the same uniforms.
    within("h_prop", torch.where(valid, ok.h_prop, 0.0), torch.where(valid, op.h_prop, 0.0),
           CONTRA_REL)
    # The kernel's proposals through the plain version, each decision taken
    # as the kernel took it (log 0 < any finite log alpha; log NaN < nothing).
    forced = torch.where(ok.accept, 0.0, math.nan)
    orr = given(cr.batch, cr.terms, cr.acc, tuning, sx, leaf, model.clock, ok.h_prop, forced,
                carry.beta_prior, **bold)
    within("lq", torch.where(valid, ok.lq, 0.0), torch.where(valid, orr.lq, 0.0), SCAN_TIE)
    check(torch.equal(orr.accept, ok.accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    logu = torch.log(u_acc)
    differ = ((logu < orr.log_alpha) & valid) != ok.accept
    gap = (logu - orr.log_alpha).abs()[differ]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    fin = torch.isfinite(orr.log_alpha)
    check(torch.equal(fin, torch.isfinite(ok.log_alpha)), f"{name}: log alpha finiteness differs")
    worst["log_alpha"] = float((ok.log_alpha - orr.log_alpha).abs()[fin].max())
    for what, a, b in (("heights", ck.batch.heights, cr.batch.heights),
                       ("rates", ck.batch.rates, cr.batch.rates), ("terms", ck.terms, cr.terms)):
        within(what, a, b, CONTRA_REL)
    check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
    check(0 < int(ok.accept.sum()) < int(valid.sum()), f"{name}: not a mixed case")
    (l0, m0), (l1, _) = lengths(carry.batch), lengths(ck.batch)
    worst["distances"] = float(((l1 - l0).abs() / m0.clamp(min=1e-30)).max())
    check(worst["distances"] <= CONTRA_REL, lambda: f"{name}: a branch distance moved by "
          f"{worst['distances']:.3g} of its heights' products")
    direct = prior_terms_plain(model, ck.batch)
    fin = torch.isfinite(direct)
    check(torch.equal(fin, torch.isfinite(ck.terms)), f"{name} terms: finiteness differs")
    err = (ck.terms[fin] - direct[fin]).abs()
    worst["fresh_terms"] = float(err.max())
    check(bool((err <= CONTRA_REL * (1 + direct[fin].abs())).all()),
          lambda: f"{name} terms: off a fresh evaluation by {worst['fresh_terms']:.3g}")
    n_bits = sum(int((x != y).sum()) for x, y in (
        (ck.batch.heights, cp.batch.heights), (ck.batch.rates, cp.batch.rates),
        (ck.terms, cp.terms)))
    log(f"[kernels] {name}: {tuple(u_acc.shape)} tickets, {int(ok.accept.sum())} accepts, "
        f"{int(differ.sum())} tie decisions differ from the replay, "
        f"{int((ok.accept != op.accept).sum())} from the plain run, {n_bits} values not "
        f"bitwise equal to the plain run's; largest differences {json.dumps(worst)}")
    return worst, ok, lambda fn: run(fn, ck if fn is kernel else cp)


def _contra_steps(fs, mode):
    """The plan steps of a K6 mode: ``(label, rows bucket, step)`` for the
    first contrary slide step, or the first block of each contrary range
    bucket."""
    from mcmcdate_tpu_torch.engine import proposals as P

    if mode == "slide":
        return [("slide", None, fs.spec_t[P.K_SLIDE_NODES_CONTRA][0])]
    return sorted(((f"range {rb} rows", rb, blocks[0]) for (k, rb), blocks in fs.range_t.items()
                   if k == P.K_SCALE_SUBTREES_CONTRA), key=lambda st: st[1])


def _check_contra(mode, n_taxa):
    """K6's ``mode`` at every step of ``_contra_steps``: ``[(rows bucket,
    step, accept, ms, plain_ms, worst)]``."""
    from mcmcdate_tpu_torch.kernels import contra_step as K

    kernel, plain = getattr(K, f"contra_{mode}"), getattr(K, f"contra_{mode}_plain")
    fs, carry, tuning, gen = _fast(n_taxa)
    out = []
    for step, rb, sx in _contra_steps(fs, mode):
        u_prop, u_acc = _draws(fs, sx, tuning, gen, False)
        w, ok, run = _contra_agree(f"contra_{mode} {step} at {n_taxa} taxa", mode, fs, carry,
                                   tuning, sx, u_prop, u_acc)
        ms = _device_ms(lambda: run(kernel), only=f"contra_{mode}_kernel",
                        flush=mode == "slide")
        plain_ms = _device_ms(lambda: run(plain))
        log(f"[kernels] contra_{mode} {step} at {n_taxa} taxa: device time per call: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        out.append((rb, sx, ok.accept, ms, plain_ms, max(w["h_prop"], w["heights"])))
    return out


def check_contra_slide(n_taxa):
    [(_, sx, accept, ms, plain_ms, worst)] = _check_contra("slide", n_taxa)
    C, B = accept.shape
    KC, KT = sx["ch"].shape[1], sx["t_rows"].shape[1]
    # Bytes: per (chain, ticket) the gathered heights, rates, tuning,
    # uniforms and touched terms in, the accept mask, log alpha and the
    # proposal out, and for its accepts the height, rates, terms and count
    # out; per chain four scalars; the step's plan arrays.  Operations:
    # about 60 per touched term and 100 for the truncated normal (each
    # special function counted as 10).
    # Its birth-death terms (1 + KC a ticket) in double: about 100 operations
    # each, as the other records count them.
    nbytes = (4 * C * B * (9 + 2 * KC + KT) + C * B + 16 * C + B * (4 * (4 + KC + KT) + 1)
              + 4 * int(accept.sum()) * (3 + KC + KT))
    ops = C * B * (60 * KT + 100)
    rec = _record(worst, ms, plain_ms, nbytes, ops, ops64=100 * C * B * (1 + KC))
    log(f"[kernels] contra_slide at {n_taxa} taxa: bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}); without the double operations "
        f"{_bound(nbytes, ops)[0]:.4f} ms")
    return {"contra_slide": rec}


def check_contra_range(n_taxa):
    """A record per row bucket: ``contra_range_16``, ``_64``, ``_256``."""
    out = {}
    for rb, sx, accept, ms, plain_ms, worst in _check_contra("range", n_taxa):
        C, S = accept.shape
        RB = sx["own"].shape[1]
        rows = (sx["own"] >= 0).sum(1)                      # valid rows per ticket [S]
        R = int(rows.sum())
        acc_rows = int((accept.to(rows.dtype) * rows).sum())
        # Bytes: per (chain, ticket) the tuning, uniforms and parent height
        # in and the accept mask, log alpha and proposal out; per chain and
        # valid row its height, rate and two terms in, and for the accepted
        # tickets' rows the same out; per chain four scalars; the block's
        # plan arrays (rows, parents, leaf flags).  Operations: about 120
        # per row (its birth-death term in double and its clock term) and
        # 100 per ticket for the truncated normal (special functions
        # counted as 10).
        nbytes = (4 * C * S * 7 + C * S + 4 * C * R * 4 + 4 * acc_rows * 4 + 16 * C
                  + S * RB * 9 + 4 * S * 8)
        out[f"contra_range_{rb}"] = _record(worst, ms, plain_ms, nbytes,
                                            C * (120 * R + 100 * S))
    return out


_GLOB = {}


def _glob_fast(n_taxa):
    """FastSweeps on the synthetic model of a shape with the smoke's node
    priors and the calibrated proposal table, where all 14 glob families
    appear, with a carry (z and q filled), a tuning and a generator (built
    once)."""
    import dataclasses

    import torch

    from mcmcdate_tpu_torch.engine import fast_sweep, proposals as P

    if n_taxa not in _GLOB:
        model, batch = _model(n_taxa)
        cal, con, br = _node_priors(model.topo)
        model = dataclasses.replace(model, calibrations=cal, constraints=con, braces=br)
        table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)
        fs = fast_sweep.FastSweeps(model, table)
        carry = fs.init_carry(batch)
        carry.z, carry.q = fs._zq_from_y(model.whitened_residual_internal(carry.batch))
        gen = torch.Generator(device="cuda").manual_seed(n_taxa + 1)
        tuning = 0.3 + 2.7 * torch.rand((CHAINS, table.n_proposals), generator=gen,
                                        device="cuda")
        _GLOB[n_taxa] = fs, carry, tuning, gen
    return _GLOB[n_taxa]


def _glob_draws(fam, tuning, gen):
    """A family's draws as ``FastSweeps.glob_phase`` makes them: ``(tun,
    draws, u_acc)``, each ``[C, n]``."""
    import torch

    from mcmcdate_tpu_torch.kernels import glob_step as G
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    tun = tuning.index_select(1, fam.rows)
    draws = (standard_gamma(fam.sd / tun, gen) if fam.tag in G.GAMMA_TAGS
             else torch.rand((CHAINS, fam.n), generator=gen, device="cuda"))
    return tun, draws, torch.rand((CHAINS, fam.n), generator=gen, device="cuda")


def _glob_run(fs, fam, carry, tun, draws, u_acc, **bold):
    """A family through the glob kernels, as ``FastSweeps.glob_phase``
    runs it: ``(accept, prop, mean)`` ``[C, n]`` (mean: var_tree's only);
    ``bold``: sub_contra's bold mixture (``u_bold``, ``bold_p``,
    ``bold_factor``)."""
    import torch

    from mcmcdate_tpu_torch.kernels import glob_step as G

    if G.FAMILIES[fam.tag].lik != G.DENSE:
        out = G.glob_scan(fs.glob, fam, carry, tun, draws, u_acc, **bold)
        return out.accept, out.prop, None
    acc, prop, mean = [], [], []
    nbad = None
    for s in range(fam.n):
        pro = G.glob_dense_prologue(fs.glob, fam, s, carry, tun, draws, nbad)
        nbad = pro.nbad
        acc.append(G.glob_dense_epilogue(fs.glob, fam, s, carry, pro, fs.glob_product(fam, s, pro),
                                         u_acc))
        prop.append(pro.prop)
        mean.append(pro.mean)
    return (torch.stack(acc, 1), torch.stack(prop, 1),
            torch.stack(mean, 1) if fam.tag == "var_tree" else None)


def _glob_agree(name, fs, carry, fam, tun, draws, u, q_scale=None, bold=None):
    """One family through the glob kernels against its plain scan, on
    copies of ``carry``: the kernels' proposals (and var_tree's rate means)
    against the plain version's from the same draws; the kernels'
    proposals replayed through ``glob_family_plain`` with every decision
    taken as the kernels took it, whose log alpha must give the kernels'
    decisions except at ties and whose heights, rates, scalars and terms
    must equal the kernels' bitwise, with d, z and q within SCAN_REL of
    their scale (q's each chain's ``q_scale(replay carry, proposals)``
    where given) and equal accept counts; ``bold`` (sub_contra: ``u_bold``,
    ``bold_p``, ``bold_factor``) adds the bold mixture, which the replay
    takes as its tuning.  Returns ``(worst differences, accept)``."""
    import torch

    from mcmcdate_tpu_torch.ops.dists import bold_tune

    bold = bold or {}
    ck, cr = _copy_carry(carry), _copy_carry(carry)
    accept, prop, mean = _glob_run(fs, fam, ck, tun, draws, u, **bold)
    _sync()
    forced = torch.where(accept, 0.0, math.nan)
    rec = fs.glob_family_plain(fam.tag, cr, bold_tune(tun, **bold), draws, forced,
                               given=dict(prop=prop, mean=mean))
    _sync()
    worst = {}

    def within(what, a, b, lim):
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a)), f"{name} {what}: finiteness differs")
        err = (a - b).abs()[fin]
        worst[what] = float(err.max()) if err.numel() else 0.0
        check(bool((err <= lim[fin] if torch.is_tensor(lim) else err <= lim).all()),
              lambda: f"{name} {what}: off the plain version by {worst[what]:.3g}")

    lim = CONTRA_REL * (1 + rec.prop.abs())
    if rec.dx_dp is not None:
        lim = lim + PROP_ULPS * torch.finfo(torch.float32).eps * rec.dx_dp
    within("prop", prop, rec.prop, lim)
    if mean is not None:
        within("mean", mean, rec.mean, CONTRA_REL * (1 + rec.mean.abs()))
    check(torch.equal(rec.accept, accept),
          f"{name}: the kernel accepted a proposal whose log alpha the plain version makes -inf")
    differ = (torch.log(u) < rec.log_alpha) != accept
    gap = (torch.log(u) - rec.log_alpha).abs()[differ]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions differ "
          f"beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
    for what in ("heights", "rates", "birth", "death", "height", "rate_mean", "rate_var"):
        a, b = getattr(ck.batch, what), getattr(cr.batch, what)
        check(_same(a, b), lambda: f"{name} {what}: {int((a != b).sum())} values differ from "
              f"the replay's")
    check(_same(ck.terms, cr.terms), lambda: f"{name} terms: "
          f"{int((ck.terms != cr.terms).sum())} values differ from the replay's")
    for what, a, b in (("d", ck.d, cr.d), ("z", ck.z, cr.z), ("q", ck.q, cr.q)):
        scale = (q_scale(cr, prop) if what == "q" and q_scale
                 else max(1.0, float(b.abs().max())))
        within(what, a, b, SCAN_REL * scale)
    check(torch.equal(ck.acc, cr.acc), f"{name}: accept counts differ")
    log(f"[kernels] {name}: {fam.n} tickets, {int(accept.sum())} accepts of {accept.numel()}, "
        f"{int(differ.sum())} tie decisions differ from the replay, state and terms bitwise "
        f"equal to it; largest differences {json.dumps(worst)}")
    return worst, accept


def _glob_dense_family(fs, fam, carry, tun, draws):
    """G2 on every ticket of a dense family in turn, from ``carry`` (read,
    not changed), as ``glob_phase`` launches it: the prologues' outputs."""
    from mcmcdate_tpu_torch.kernels import glob_step as G

    out, nbad = [], None
    for s in range(fam.n):
        pro = G.glob_dense_prologue(fs.glob, fam, s, carry, tun, draws, nbad)
        nbad = pro.nbad
        out.append(pro)
    return out


def _log_record(name, n_taxa, r, what):
    log(f"[glob] {name} at {n_taxa} taxa ({what}): {json.dumps(r)}")


def check_glob(n_taxa):
    """G1-G3 on all 14 glob families of the calibrated synthetic model,
    each family's tickets in full, against the plain scan; then
    ``FastSweeps.glob_phase`` on the card launches only the glob kernels
    (never K1 nor the plain step).  The records time G1 on bd_scale (the
    family with the most tickets), G2 per ticket over the whole sub_ultra
    family and G3 on sub_ultra's first ticket; the log adds G1 on
    sub_contra, G2 on sub_ultra's first ticket and on one var_tree ticket,
    and each subtree ticket's product over its support rows against the
    full product.  Each bound counts what the call needs at its tickets:
    a subtree ticket's range of nodes, terms and distance rows, the whole
    term blocks where the invalid rule reads them (the count of bad
    entries), the draws, and the outputs the contract asks for."""
    import numpy as np

    from mcmcdate_tpu_torch.engine.fast_sweep import GLOB_ORDER
    from mcmcdate_tpu_torch.kernels import glob_step as G

    fs, carry, tuning, gen = _glob_fast(n_taxa)
    check(tuple(fs.glob_fam) == GLOB_ORDER,
          f"the calibrated model has the glob families {tuple(fs.glob_fam)}")
    worst, n_acc, n_all, draws_of = {}, 0, 0, {}
    for tag, fam in fs.glob_fam.items():
        draws_of[tag] = _glob_draws(fam, tuning, gen)
        w, accept = _glob_agree(f"glob {tag} at {n_taxa} taxa", fs, carry, fam, *draws_of[tag])
        for k, v in w.items():
            worst[k] = max(worst.get(k, 0.0), v)
        n_acc += int(accept.sum())
        n_all += accept.numel()
        draws_of[tag] += (accept,)
    check(0 < n_acc < n_all, f"glob families accepted {n_acc} of {n_all}: not a mixed case")
    dense = [f for f in fs.glob_fam.values() if G.FAMILIES[f.tag].lik == G.DENSE]
    counts, _ = _counted(lambda: fs.glob_phase(_copy_carry(carry), tuning, gen))
    want = dict(glob_scan=len(fs.glob_fam) - len(dense),
                glob_dense_prologue=sum(f.n for f in dense),
                glob_dense_epilogue=sum(f.n for f in dense))
    check({k: v for k, v in counts.items() if v} == want,
          f"glob_phase launched {counts}, not only the glob kernels {want}")
    C, N = carry.batch.heights.shape
    D = carry.d.shape[1]
    nn = carry.terms.shape[1] - 4 - 2 * (N + 1)  # node-prior terms
    log(f"[kernels] glob_phase at {n_taxa} taxa: launches {want}, K1 and the plain step none")

    def scan_record(tag):
        """G1 on a whole family: ``(record, smem bytes, arrays in shared
        memory)``."""
        fam = fs.glob_fam[tag]
        tun, draws, u, accept = draws_of[tag]
        c1, c2 = _copy_carry(carry), _copy_carry(carry)
        smem = G.glob_scan_smem(fs.glob, fam, c1)
        ms = _device_ms(lambda: G.glob_scan(fs.glob, fam, c1, tun, draws, u),
                        only="glob_scan_kernel")
        plain = _device_ms(lambda: fs.glob_family_plain(tag, c2, tun, draws, u), reps=3)
        n = fam.n
        moved = int(accept.any(1).sum())
        draws_b = C * (4 * 3 * n + 5 * n)  # tun, draw, u_acc in; accept, prop out
        if tag == "bd_scale":
            # Per chain the heights, the sc and bd blocks and the five
            # scalars in; for the chains that accepted a ticket the two
            # blocks and the two rates out; the family's plan arrays.
            # Operations: per chain and ticket the birth-death block in
            # double (about 100 per node, each exp or log counted as 10)
            # and the proposal and scalar terms (about 100 in float32).
            nbytes = draws_b + 4 * C * (N + (N + 5) + 5) + moved * 4 * (N + 7) + 12 * n
            return _record(worst["prop"], ms, plain, nbytes, 100 * C * n,
                           ops64=100 * C * n * (N + 1)), smem
        # sub_contra.  Bytes: per chain the heights, the bd and ck blocks
        # whole (the invalid rule counts their bad entries), the node-prior
        # block and the rates on the union U of the tickets' ranges in; for
        # the chains that accepted a ticket heights, rates and both blocks
        # on U out (its upper bound); the plan arrays.  Operations: per
        # chain and ticket its range's birth-death terms in double and
        # clock terms (about 40 each) in float32, the node-prior block and
        # the proposal (about 100).
        grp = fam.grp
        span = (grp.hi - grp.lo).astype(np.int64)
        union = np.zeros(N, bool)
        for lo, hi in zip(grp.lo, grp.hi):
            union[lo:hi] = True
        U = int(union.sum())
        nbytes = (draws_b + 4 * C * (N + 2 * (N + 1) + nn + U) + moved * 4 * 4 * U
                  + 4 * 9 * n)
        return _record(worst["prop"], ms, plain, nbytes,
                       C * int((40 * span + 20 * nn + 100).sum()),
                       ops64=100 * C * int(span.sum())), smem

    g1, smem1 = scan_record("bd_scale")
    g1_sub, smem_sub = scan_record("sub_contra")
    _log_record("glob_scan", n_taxa, g1, f"bd_scale, {fs.glob_fam['bd_scale'].n} tickets, "
                f"{smem1[0]} B shared {list(smem1[1])}")
    _log_record("glob_scan", n_taxa, g1_sub, f"sub_contra, {fs.glob_fam['sub_contra'].n} "
                f"tickets, {smem_sub[0]} B shared {list(smem_sub[1])}")

    def prologue_bytes(tag, s, first):
        """G2's bytes at ticket s: see the records below."""
        fam = fs.glob_fam[tag]
        if tag in G.SUBTREE_DENSE:
            K = int(fam.grp.hi[s]) - int(fam.grp.lo[s])
            # In: the range's heights (and its parent's), rates, bd and ck
            # terms, the node-prior block, d (copied to d_new), five
            # scalars, two draws; at the family's first ticket the bd and
            # ck blocks whole (the count of bad entries).  Out: the
            # proposed heights or rates and terms on the range, the
            # node-prior block, d_new, delta, delta_S, five scalars, six
            # per-chain values.
            blk = (2 if "bd" in G.FAMILIES[tag].blocks else 1) * K
            nin = (K + 1) + K + blk + nn + D + 7 + (2 * (N + 1) if first else 0)
            nout = K + blk + nn + 2 * D + K + 11 + (1 if first else 0)
            return 4 * C * (nin + nout)
        # var_tree: in the rates (the mean, the proposal), the heights (the
        # clock terms), the sc and ck blocks, d, five scalars, two draws;
        # out the proposed rates, the sc and ck blocks, d_new, delta, five
        # scalars, six per-chain values.
        return 4 * C * ((2 * N + (N + 5) + D + 7) + (N + (N + 5) + 2 * D + 11))

    def prologue_ops(tag, s):
        fam = fs.glob_fam[tag]
        if tag in G.SUBTREE_DENSE:
            K = int(fam.grp.hi[s]) - int(fam.grp.lo[s])
            bd = "bd" in G.FAMILIES[tag].blocks
            # Its range's clock terms (about 40 each), distances (4 a row),
            # node-prior block and proposal in float32; birth-death terms in
            # double (100 each).
            return C * (40 * K + 4 * K + 20 * nn + 100), (100 * C * K if bd else 0)
        return C * (40 * (N + 1) + N + 4 * D + 100), 0

    # G2 over the whole sub_ultra family, per ticket, and on its first.
    fam = fs.glob_fam["sub_ultra"]
    tun, draws, u, accept = draws_of["sub_ultra"]
    c3 = _copy_carry(carry)
    pros = _glob_dense_family(fs, fam, c3, tun, draws)
    ms2 = _device_ms(lambda: _glob_dense_family(fs, fam, c3, tun, draws),
                     only="glob_dense_prologue_kernel", reps=3) / fam.n
    plain2 = _device_ms(lambda: [G.glob_dense_prologue_plain(
        fs.glob, "sub_ultra", c3, tun[:, s], fam.ticket(s), draws[:, s]) for s in range(fam.n)],
        reps=1) / fam.n
    nb2 = sum(prologue_bytes("sub_ultra", s, s == 0) for s in range(fam.n)) / fam.n
    ops2 = [sum(x) / fam.n for x in zip(*(prologue_ops("sub_ultra", s) for s in range(fam.n)))]
    g2 = _record(worst["prop"], ms2, plain2, nb2, ops2[0], ops64=ops2[1])
    ms2_0 = _device_ms(lambda: G.glob_dense_prologue(fs.glob, fam, 0, c3, tun, draws),
                       only="glob_dense_prologue_kernel")
    plain2_0 = _device_ms(lambda: G.glob_dense_prologue_plain(
        fs.glob, "sub_ultra", c3, tun[:, 0], fam.ticket(0), draws[:, 0]))
    o0 = prologue_ops("sub_ultra", 0)
    _log_record("glob_dense_prologue", n_taxa, g2, f"sub_ultra, per ticket over its {fam.n}")
    _log_record("glob_dense_prologue", n_taxa,
                _record(worst["prop"], ms2_0, plain2_0, prologue_bytes("sub_ultra", 0, True),
                        o0[0], ops64=o0[1]),
                f"sub_ultra's first ticket, {int(fam.grp.hi[0] - fam.grp.lo[0])} nodes, "
                f"counting the bad entries")
    # G2 on var_tree's first ticket.
    fv = fs.glob_fam["var_tree"]
    tv, dv, _, _ = draws_of["var_tree"]
    ms_v = _device_ms(lambda: G.glob_dense_prologue(fs.glob, fv, 0, c3, tv, dv),
                      only="glob_dense_prologue_kernel")
    plain_v = _device_ms(lambda: G.glob_dense_prologue_plain(
        fs.glob, "var_tree", c3, tv[:, 0], fv.ticket(0), dv[:, 0]))
    ov = prologue_ops("var_tree", 0)
    _log_record("glob_dense_prologue", n_taxa,
                _record(worst["prop"], ms_v, plain_v, prologue_bytes("var_tree", 0, False),
                        ov[0], ops64=ov[1]), "var_tree's first ticket")

    # Each subtree ticket's product over its support rows against the full
    # product, on the G2 outputs above: equal within K2_REL of the largest
    # |w|; bound 2 C K D operations at the f32 peak (bytes: P[S], delta_S
    # in, w out).
    fP = fs._x_P
    w_err = 0.0
    for s, pro in enumerate(pros):
        wr, wf = fs.glob_product(fam, s, pro), fP(pro.delta)
        w_err = max(w_err, float((wr - wf).abs().max()) / max(1.0, float(wf.abs().max())))
    check(w_err <= K2_REL, f"the support-row product is off the full one by {w_err:.3g} of scale")
    ms_r = _device_ms(lambda: [fs.glob_product(fam, s, p) for s, p in enumerate(pros)],
                      reps=3) / fam.n
    ms_f = _device_ms(lambda: [fP(p.delta) for p in pros], reps=3) / fam.n
    Ks = (fam.grp.hi - fam.grp.lo).astype(np.int64)
    b_r = statistics.fmean(_bound(4 * (K * D + C * K + C * D), 2 * C * K * D)[0] for K in Ks)
    b_f = _bound(4 * (D * D + 2 * C * D), 2 * C * D * D)[0]
    log(f"[glob] subtree product at {n_taxa} taxa (sub_ultra, per ticket over its {fam.n}, "
        f"mean K {statistics.fmean(Ks.tolist()):.1f} of D {D}): support rows {ms_r:.4f} ms "
        f"(bound {b_r:.4f}), full {ms_f:.4f} ms (bound {b_f:.4f}), largest difference "
        f"{w_err:.3g} of scale; {2 * C * int(Ks.sum()) * D / 1e9:.3f} against "
        f"{2 * C * fam.n * D * D / 1e9:.3f} GFLOP for the family")

    def epilogue_record(tag):
        """G3 on the family's first ticket (kernel, plain, bound), after G2
        and the product.  Bytes: each value the function must move, once.
        Every chain: u_acc, d_pr, lmhg, lj, invalid and q in, the accept
        flag out, and dq's rows of delta, z and w in (a subtree ticket's
        delta_S and its support rows of z and w; a whole-D family's all D).
        An accepted chain also: the rest of z and w in and z out over D; the
        family's scalars, term blocks (a subtree ticket's bd and ck range),
        heights or rates (its range) and d (its support rows) in from the
        proposal and out; q out, the accept count in and out.  Operations:
        dq, 4 per row.  The log also gives the coarser full-D bound (every
        chain reads delta, z and w over D)."""
        f = fs.glob_fam[tag]
        spec = G.FAMILIES[tag]
        tun_f, draws_f, u_f, _ = draws_of[tag]
        ca, cb = _copy_carry(carry), _copy_carry(carry)
        pro = G.glob_dense_prologue(fs.glob, f, 0, ca, tun_f, draws_f)
        pplain = G.glob_dense_prologue_plain(fs.glob, tag, cb, tun_f[:, 0], f.ticket(0),
                                             draws_f[:, 0])
        w = fs.glob_product(f, 0, pro)
        acc0 = G.glob_dense_epilogue(fs.glob, f, 0, _copy_carry(carry), pro, w, u_f)
        ms3 = _device_ms(lambda: G.glob_dense_epilogue(fs.glob, f, 0, ca, pro, w, u_f),
                         only="glob_dense_epilogue_kernel", flush=True)
        plain3 = _device_ms(lambda: G.glob_dense_epilogue_plain(fs.glob, tag, cb, pplain, w,
                                                                 u_f[:, 0], int(f.grp.rows[0])))
        sub = tag in G.SUBTREE_DENSE
        K = int(f.grp.hi[0] - f.grp.lo[0]) if sub else 0
        rows = K if sub else D
        nodes = K if sub else N
        blocks = {"sc": 4, "bd": K if sub else N + 1, "ck": K if sub else N + 1, "nd": nn}
        blk = sum(blocks[b] for b in spec.blocks)
        n_state = sum(nodes for x in ("heights", "rates") if x in spec.fields)
        n_sc = sum(1 for x in spec.fields if x not in ("heights", "rates"))
        na = int(acc0.sum())
        every = 4 * C * (6 + 3 * rows) + C
        accepted = 4 * na * (2 * (D - rows) + D + 2 * (blk + n_state + n_sc + rows) + 3)
        nb = every + accepted
        old_blk = 2 * K + nn if sub else blk
        nb_old = 4 * C * (3 * D + 6) + 4 * na * (2 * (K + old_blk + 2 * D) + 2)
        rec = _record(max(worst["d"], worst["z"], worst["q"]), ms3, plain3, nb, 4 * C * rows)
        log(f"[glob] glob_dense_epilogue at {n_taxa} taxa ({tag}'s first ticket, "
            f"{'K ' + str(K) + ' support rows' if sub else 'D ' + str(D) + ' rows'}, {na} "
            f"accepts of {C}): {json.dumps(rec)}; full-D bound "
            f"{_bound(nb_old, 4 * C * D)[0]:.4f} ms")
        return rec

    g3 = epilogue_record("sub_ultra")
    epilogue_record("var_tree")
    return {
        "glob_scan": g1,
        "glob_dense_prologue": g2,
        "glob_dense_epilogue": g3,
    }


# -- the likelihood temperature of the decision kernels, and cascade_seed ------


def _ladder(C):
    """The 128-point stepping-stone ladder tiled over ``C`` chains, float32
    on the card: every beta in [0, 1], C / 128 chains at beta = 0."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine.stepping_stone import N_POINTS, beta_ladder

    return torch.as_tensor(np.resize(beta_ladder(N_POINTS), C), dtype=torch.float32,
                           device="cuda")


def _mc3_ladder(C):
    """A 4-rung MC3 ladder (rung gaps MC3_DT, inside the range the run's
    tuning keeps them in) tiled over ``C`` chains, float32 on the card."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine.mc3 import ladder_of

    return torch.as_tensor(np.resize(ladder_of(MC3_DT), C), dtype=torch.float32, device="cuda")


def _in_turns(fn, carry, beta, beta_prior, only):
    """Flushed device ms of ``fn()`` with ``carry.beta`` and
    ``carry.beta_prior`` None (ones vectors) and ``beta`` and
    ``beta_prior``, in turns (ones, ladders, ladders, ones): ``(ones,
    ladders)``, each the mean of its two timings."""
    ms = {"ones": 0.0, "beta": 0.0}
    for which in ("ones", "beta", "beta", "ones"):
        carry.beta = None if which == "ones" else beta
        carry.beta_prior = None if which == "ones" else beta_prior
        ms[which] += _device_ms(fn, only=only, flush=True) / 2
    return ms["ones"], ms["beta"]


def _scan_pair_agree(name, worst, out_k, out_p, d_pr, lmhg, u, beta, beta_prior):
    """A scan kernel's ``(accept, dq)`` against its plain version's, both
    tempered by ``beta`` and ``beta_prior``: per chain equal up to the first
    decision that differs, which must be a tie of the tempered log alpha
    (SCAN_TIE); dq within SCAN_REL of the chain's largest |dq| up to there.
    Returns the number of decisions that differ."""
    import torch

    (ak, dk), (ap, dp) = out_k, out_p
    la = torch.nan_to_num(beta_prior[:, None] * d_pr - 0.5 * (beta[:, None] * dp) + lmhg,
                          nan=-math.inf)
    differ = ak != ap
    first = torch.where(differ.any(1), differ.int().argmax(1), ak.shape[1])
    upto = torch.arange(ak.shape[1], device=ak.device)[None, :] <= first[:, None]
    gap = (torch.log(u) - la).abs()[differ & upto]
    check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: decisions differ beyond ties "
          f"(largest |log u - log alpha| {float(gap.max()):.3g})")
    scale = dp.abs().amax(1, keepdim=True).clamp(min=1.0)
    err = ((dk - dp).abs() / scale)[upto]
    worst["dq"] = max(worst.get("dq", 0.0), float(err.max()))
    check(bool((err <= SCAN_REL).all()), lambda: f"{name}: dq off the plain version by "
          f"{worst['dq']:.3g} of its scale")
    check(0 < int(ak.sum()) < ak.numel(), f"{name}: not a mixed case")
    return int(differ.sum())


def check_tempered(n_taxa):
    """The ten decision sites with both temperatures of each chain: the
    128-point ladder tiled over the chains as the likelihood's (``_ladder``)
    and a 4-rung MC3 ladder as the prior's (``_mc3_ladder``), each kernel
    against its plain version, both tempered: K3 (after T1 and K2) on one
    ticket of every kind and likelihood class and T3's light and heavy
    kernels on a 256-ticket run (replayed, as check_ticket), K4
    ``point_scan`` on the first step of both point kinds and K5
    ``range_scan`` on the first block of every likelihood bucket (the scans'
    inputs recorded from the tempered step), G1 and G3 on all 14 glob
    families (replayed, as check_glob), K6 in both modes (replayed, as
    check_contra_slide; the prior ladder alone: no likelihood) and,
    without a likelihood, the K4 and K5 epilogues' own decisions (replayed,
    as check_prior_only_steps).  Each is timed flushed with ones vectors
    and with the ladders, in turns: the pulley's K3, T3's run, K4's slide
    step, K5's largest block, G1 on bd_scale, G3 on sub_ultra's first
    ticket, K6 on its first slide step and each range bucket's first block,
    the epilogues on the first slide step and the largest range block.
    Returns per record ``(max_abs_err, ms tempered, ms untempered)`` as a
    dict."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import mh as M, proposals as P
    from mcmcdate_tpu_torch.kernels import contra_step as K6, glob_step as G, ticket_step as TS
    from mcmcdate_tpu_torch.kernels.accept_select import accept_select
    from mcmcdate_tpu_torch.kernels.point_scan import point_scan, point_scan_plain
    from mcmcdate_tpu_torch.kernels.range_scan import range_scan, range_scan_plain
    from mcmcdate_tpu_torch.kernels.ticket_step import TicketDraws, ticket_prologue, ticket_scan
    from mcmcdate_tpu_torch.ops.dists import standard_gamma

    out = {}
    beta, bprior = _ladder(CHAINS), _mc3_ladder(CHAINS)
    # K3 and T3.
    fs, fcarry, tuning, gen = _glob_fast(n_taxa)
    tk = M.MHKernel(fs.model, fs.table)
    tt = tk.tt
    carry = tk.init_carry(fcarry.batch)
    carry.beta, carry.beta_prior = beta, bprior
    C = CHAINS

    def draw_of(p):
        return (standard_gamma(float(tt.table.par[p]) / tuning[:, p], gen) if tt.gamma[p]
                else torch.rand(C, generator=gen, device="cuda"))

    rows = {}
    for p, kind in enumerate(tt.table.kind):
        rows.setdefault((int(kind), int(tt.d_class[p])), p)
    worst, ties, n_acc = {}, 0, 0
    for p in sorted(set(rows.values())):
        t, a = _ticket_one_agree(f"tempered ticket {tt.table.names[p]} at {n_taxa} taxa", tk,
                                 carry, tuning, p, draw_of(p),
                                 torch.rand(C, generator=gen, device="cuda"), worst)
        ties, n_acc = ties + t, n_acc + a
    check(n_acc > 0, "the tempered ticket checks accepted nothing")
    p = int(np.nonzero(tt.table.kind == P.K_PULLEY_ULTRA)[0][0])
    dr = TicketDraws.single(p, draw_of(p), torch.rand(C, generator=gen, device="cuda"))
    c3 = _mh_copy(carry)
    pro = ticket_prologue(tt, c3, tuning, dr, 0)
    dy, d_lik = tk._k2(c3, p, pro)
    ms = _in_turns(lambda: accept_select(tt, c3, tuning, dr, 0, pro, dy, d_lik), c3, beta,
                   bprior, "accept_select_kernel")
    out["accept_select"] = dict(max_abs_err=worst.get("y", 0.0), ms=ms[1], ms_untempered=ms[0])
    log(f"[tempered] accept_select at {n_taxa} taxa: {len(set(rows.values()))} rows, {n_acc} "
        f"accepts, {ties} tie decisions; the pulley flushed {ms[1]:.4f} ms with the ladders, "
        f"{ms[0]:.4f} ms untempered")
    tickets = np.asarray(tt.table.tickets)
    ok = np.asarray([not tt.breaks(int(q)) for q in tickets])
    order = np.random.default_rng(n_taxa + 2).choice(tickets[ok], 256).astype(np.int32)
    sdr = tk.draws(order, tuning, gen)
    saved = TS.HEAVY
    w3, t3 = {}, {}
    try:
        for kind, heavy in (("light", 10 ** 9), ("heavy", -1)):
            TS.HEAVY = heavy
            before = dict(ticket_scan.launches_by_kind)
            ties, n_acc, n_all = _ticket_scan_agree(f"tempered ticket_scan ({kind}) at {n_taxa} "
                                                    f"taxa", tk, carry, tuning, sdr, w3)
            check(ticket_scan.launches_by_kind[kind] == before[kind] + 1,
                  f"tempered ticket_scan did not take its {kind} kernel")
            check(0 < n_acc < n_all, f"tempered ticket_scan accepted {n_acc} of {n_all}")
            c5 = _mh_copy(carry)
            t3[kind] = _in_turns(lambda: ticket_scan(tt, c5, tuning, sdr, 0, len(order)), c5,
                                 beta, bprior, T3_KERNELS)
    finally:
        TS.HEAVY = saved
    out["ticket_scan"] = dict(max_abs_err=max(w3.get("prop", 0.0), w3.get("y", 0.0)),
                              ms=t3["light"][1], ms_untempered=t3["light"][0],
                              heavy_ms=t3["heavy"][1], heavy_ms_untempered=t3["heavy"][0])
    log(f"[tempered] ticket_scan at {n_taxa} taxa: a 256-ticket run flushed, light "
        f"{t3['light'][1]:.4f} ms with the ladders, {t3['light'][0]:.4f} untempered; heavy "
        f"{t3['heavy'][1]:.4f} and {t3['heavy'][0]:.4f}")
    # G1 and G3.
    fcarry = _copy_carry(fcarry)
    fcarry.beta, fcarry.beta_prior = beta, bprior

    def mu_z(c):
        return (fs.glob.mu.abs() * c.z.abs()).sum(1)

    q0, mz0 = fcarry.q.abs(), mu_z(fcarry)

    def q_scale(c, u):
        # A uniform family's ticket moves q by the closed form dq = (u^2 - 1)
        # q + 2 u (u - 1) mu'z + (u - 1)^2 mu'P mu, and G1 sums mu'z in
        # another order than the plain version, so q's float32 error scales
        # with the magnitude of those terms summed over the family's
        # tickets, not with q: a chain at a small beta takes scales of up to
        # 2.4 on the prior alone (measured on the H100: errors up to 4e-7 of
        # that sum, 0.02 at 1000 taxa, where q is about 1,000).
        um1 = (u - 1).abs()
        terms = ((u * u - 1).abs() * torch.maximum(q0, c.q.abs())[:, None]
                 + 2 * (u * um1).abs() * torch.maximum(mz0, mu_z(c))[:, None]
                 + um1 * um1 * abs(fs.glob.mPm))
        return terms.sum(1).clamp(min=1.0)

    wg = {"glob_scan": {}, "glob_dense_epilogue": {}}
    for tag, fam in fs.glob_fam.items():
        tun, draws, u = _glob_draws(fam, tuning, gen)
        uniform = G.FAMILIES[tag].lik == G.UNIFORM
        w, _ = _glob_agree(f"tempered {tag} at {n_taxa} taxa", fs, fcarry, fam, tun, draws, u,
                           q_scale if uniform else None)
        key = "glob_dense_epilogue" if G.FAMILIES[tag].lik == G.DENSE else "glob_scan"
        for k, v in w.items():
            wg[key][k] = max(wg[key].get(k, 0.0), v)
    fam = fs.glob_fam["bd_scale"]
    tun, draws, u = _glob_draws(fam, tuning, gen)
    c6 = _copy_carry(fcarry)
    ms = _in_turns(lambda: G.glob_scan(fs.glob, fam, c6, tun, draws, u), c6, beta, bprior,
                   "glob_scan_kernel")
    out["glob_scan"] = dict(max_abs_err=max(wg["glob_scan"].values()), ms=ms[1],
                            ms_untempered=ms[0])
    fam = fs.glob_fam["sub_ultra"]
    tun, draws, u = _glob_draws(fam, tuning, gen)
    c7 = _copy_carry(fcarry)
    gpro = G.glob_dense_prologue(fs.glob, fam, 0, c7, tun, draws)
    wprod = fs.glob_product(fam, 0, gpro)
    ms3 = _in_turns(lambda: G.glob_dense_epilogue(fs.glob, fam, 0, c7, gpro, wprod, u), c7,
                    beta, bprior, "glob_dense_epilogue_kernel")
    out["glob_dense_epilogue"] = dict(max_abs_err=max(wg["glob_dense_epilogue"].values()),
                                      ms=ms3[1], ms_untempered=ms3[0])
    log(f"[tempered] glob_scan on bd_scale at {n_taxa} taxa flushed: {ms[1]:.4f} ms with the "
        f"ladders, {ms[0]:.4f} untempered; glob_dense_epilogue on sub_ultra's first ticket "
        f"{ms3[1]:.4f} and {ms3[0]:.4f}")
    # K4 and K5: the scans' inputs from the tempered steps.
    fs, carry0, tuning, gen = _fast(n_taxa)
    carry = _copy_carry(carry0)
    carry.beta, carry.beta_prior = beta, bprior
    for step, names, kinds in (
            ("point", K4_NAMES, [(k, fs.spec_t[k][0]) for k in (P.K_SCALE_BRANCH_RATE,
                                                                P.K_SLIDE_NODE_ULTRA)]),
            ("range", ("range_lik_prologue", "range_scan", "range_lik_epilogue"),
             [(k, steps[0]) for (k, _), steps in fs.range_t.items()
              if k != P.K_SCALE_SUBTREES_CONTRA])):
        worst, ties, timed = {}, 0, None
        scan, plain = (point_scan, point_scan_plain) if step == "point" else (range_scan,
                                                                              range_scan_plain)
        for kind, sx in kinds:
            gamma = kind in (P.K_SCALE_BRANCH_RATE, P.K_SCALE_SUBTREE_RATE)
            draw, u = _draws(fs, sx, tuning, gen, gamma)
            ck = _copy_carry(carry)
            call = (fs.point_lik_step if step == "point" else fs.range_lik_step)
            rec, _ = _step_recorded(names, lambda: call(kind, ck, tuning, sx, draw, u))
            args = rec[f"{step}_scan_args"]
            check(args[-2] is beta and args[-1] is bprior,
                  f"the {step} step did not hand its scan the carry's temperatures")
            ties += _scan_pair_agree(f"tempered {step}_scan kind {kind} at {n_taxa} taxa", worst,
                                     rec[f"{step}_scan"], plain(*args), args[-5], args[-4],
                                     args[-3], beta, bprior)
            if step == "point" and kind == P.K_SLIDE_NODE_ULTRA or step == "range" and (
                    timed is None or sx["rows"].shape[0] > timed[0]["rows"].shape[0]):
                timed = sx, args
        holder = _copy_carry(carry)  # carries the temperatures that _in_turns switches
        sx, args = timed
        ms = _in_turns(lambda: scan(*args[:-2], holder.beta, holder.beta_prior), holder, beta,
                       bprior, f"{step}_scan_kernel")
        out[f"{step}_scan"] = dict(max_abs_err=worst["dq"], ms=ms[1], ms_untempered=ms[0])
        log(f"[tempered] {step}_scan at {n_taxa} taxa: {len(kinds)} steps, {ties} tie decisions; "
            f"flushed on {sx['rows'].shape[0]} tickets {ms[1]:.4f} ms with the ladders, "
            f"{ms[0]:.4f} untempered")
    # K6: the prior ladder alone (the contrary moves leave the likelihood).
    model = fs.model
    leaf = model.topo.is_leaf_t
    for mode in ("slide", "range"):
        kernel = getattr(K6, f"contra_{mode}")
        for label, rb, sx in _contra_steps(fs, mode):
            u_prop, u_acc = _draws(fs, sx, tuning, gen, False)
            c8 = _copy_carry(carry0)
            c8.beta_prior = bprior
            w, _, _ = _contra_agree(f"tempered contra_{mode} {label} at {n_taxa} taxa", mode,
                                    fs, c8, tuning, sx, u_prop, u_acc)
            holder = _copy_carry(carry0)
            ms = _in_turns(lambda: kernel(holder.batch, holder.terms, holder.acc, tuning, sx,
                                          leaf, model.clock, u_prop, u_acc, holder.beta_prior),
                           holder, None, bprior, f"contra_{mode}_kernel")
            key = "contra_slide" if mode == "slide" else f"contra_range_{rb}"
            out[key] = dict(max_abs_err=max(w["h_prop"], w["heights"]), ms=ms[1],
                            ms_untempered=ms[0])
            log(f"[tempered] contra_{mode} {label} at {n_taxa} taxa flushed: {ms[1]:.4f} ms "
                f"with the prior ladder, {ms[0]:.4f} untempered")
    # The K4 and K5 epilogues' own decisions, without a likelihood.
    out.update(_prior_only(n_taxa, bprior))
    return out


def check_cascade_seed(n_taxa):
    """cascade_seed on the kernels' batch (CHAINS chains) against its plain
    version (the per-field copy): bitwise on rung 63; the kernel timed
    flushed, the plain version, and one ``torch._foreach_copy_`` over the
    fields' rows as the library call, flushed as the kernel is.  Bound: one
    chain's row of every field read and written."""
    import torch

    from mcmcdate_tpu_torch.kernels.cascade_seed import cascade_seed, cascade_seed_plain
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    _, batch = _model(n_taxa)
    j = 63
    ck = State(**{f: getattr(batch, f).clone() for f in FIELDS})
    cp = State(**{f: getattr(batch, f).clone() for f in FIELDS})
    g = torch.Generator(device="cuda").manual_seed(n_taxa)
    for f in FIELDS:
        x = getattr(ck, f)
        x.copy_(torch.rand(x.shape, generator=g, device="cuda"))
        getattr(cp, f).copy_(x)
    cascade_seed(ck, j)
    cascade_seed_plain(cp, j)
    _sync()
    for f in FIELDS:
        check(torch.equal(getattr(ck, f), getattr(cp, f)),
              f"cascade_seed at {n_taxa} taxa: {f} differs from the per-field copy")
    ms = _device_ms(lambda: cascade_seed(ck, j), only="cascade_seed_kernel", flush=True)
    plain_ms = _device_ms(lambda: cascade_seed_plain(cp, j))
    dst = [getattr(cp, f)[j + 1] for f in FIELDS]
    src = [getattr(cp, f)[j] for f in FIELDS]
    lib_ms = _device_ms(lambda: torch._foreach_copy_(dst, src),
                        only=("multi_tensor", "opy", "Memcpy", "elementwise"), flush=True)
    row_bytes = sum(getattr(ck, f)[0].numel() * 4 for f in FIELDS)
    return {"cascade_seed": _record(0.0, ms, plain_ms, 2 * row_bytes, 0, library_ms=lib_ms)}


def check_mc3_swap(n_taxa):
    """M1 mc3_swap on the kernels' batch (CHAINS chains: MC3_GROUPS groups
    of 4 temperatures) against its plain version on the same U and draws,
    bitwise (state, U, decisions, per-pair counts), with U the chains'
    direct float32 log posteriors (their spread leaves most swaps
    rejected) and with U drawn N(0, 4^2) (a mixed case, which must have
    both); the mixed case's move timed flushed beside the plain version and
    the library route (one ``index_select`` a field).  Bound: the moved
    groups' rows of every field read and written, U read and written, the
    draws and the ladder read, the decisions and counts written."""
    import torch

    from mcmcdate_tpu_torch.engine.mc3 import N_SWAPS, N_TEMPS, swap_draws, temperature_ladder
    from mcmcdate_tpu_torch.kernels.mc3_swap import mc3_swap, mc3_swap_plain
    from mcmcdate_tpu_torch.models.state import FIELDS, State
    from mcmcdate_tpu_torch.tools.profile_sweep import direct_log_posterior

    fs, carry, _, gen = _fast(n_taxa)
    batch = carry.batch
    G = MC3_GROUPS
    betas = torch.as_tensor(temperature_ladder(), dtype=torch.float32, device="cuda")
    cases = (("posterior", direct_log_posterior(fs.model, batch, torch.float32)),
             ("mixed", 4 * torch.randn(CHAINS, generator=gen, device="cuda")))
    for case, U in cases:
        pair, u = swap_draws(gen, G)
        ck, cp = (State(**{f: getattr(batch, f).clone() for f in FIELDS}) for _ in range(2))
        Uk, Up = U.clone(), U.clone()
        ak, pak, ptk = mc3_swap(ck, Uk, pair, u, betas)
        ap, pap, ptp = mc3_swap_plain(cp, Up, pair, u, betas)
        _sync()
        name = f"mc3_swap ({case} U) at {n_taxa} taxa"
        check(torch.equal(ak, ap) and torch.equal(Uk, Up), f"{name}: decisions or U differ")
        check(torch.equal(pak, pap) and torch.equal(ptk, ptp), f"{name}: pair counts differ")
        for f in FIELDS:
            check(torch.equal(getattr(ck, f), getattr(cp, f)),
                  f"{name}: {f} differs from the plain version's")
        moved = torch.zeros(G, dtype=torch.bool, device="cuda")
        for f in FIELDS:
            x0, x1 = getattr(batch, f), getattr(cp, f)
            moved |= (x0 != x1).reshape(G, -1).any(1)
        n_moved = int(moved.sum())
        log(f"[kernels] {name}: {int(ak.sum())} of {ak.numel()} swaps accepted, "
            f"{n_moved} of {G} groups moved; per pair {pak.tolist()} of {ptk.tolist()}; state, "
            f"U, decisions and counts bitwise the plain version's")
    check(0 < int(ak.sum()) < ak.numel(), f"mc3_swap at {n_taxa} taxa: not a mixed case")
    ms = _device_ms(lambda: mc3_swap(ck, Uk, pair, u, betas), only="mc3_swap_kernel",
                    flush=True)
    plain_ms = _device_ms(lambda: mc3_swap_plain(cp, Up, pair, u, betas))
    perm = torch.randperm(CHAINS, generator=gen, device="cuda")
    lib_ms = _device_ms(lambda: [getattr(cp, f).index_select(0, perm) for f in FIELDS],
                        only="ndex", flush=True)
    row_bytes = sum(getattr(ck, f)[0].numel() * 4 for f in FIELDS)
    nbytes = (2 * n_moved * N_TEMPS * row_bytes + 2 * 4 * CHAINS + 8 * N_SWAPS * G + 4 * N_TEMPS
              + N_SWAPS * G + 8 * (N_TEMPS - 1))
    rec = _record(0.0, ms, plain_ms, nbytes, 6 * N_SWAPS * G, library_ms=lib_ms)
    log(f"[kernels] mc3_swap at {n_taxa} taxa: {n_moved} groups moved; flushed {ms:.4f} ms, "
        f"plain {plain_ms:.4f}, index_select of every field {lib_ms:.4f}, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; every group moved: "
        f"{_bound(2 * CHAINS * row_bytes, 0)[0]:.4f} ms)")
    return {"mc3_swap": rec}


_BANDED = {}


def _banded_model(n_taxa):
    """The synthetic banded model (bandwidth BANDWIDTH) and chain batch of a
    shape, built once, and the host seconds the build took."""
    from mcmcdate_tpu_torch import synthetic

    if n_taxa not in _BANDED:
        t0 = time.perf_counter()
        model, batch = synthetic.build(n_taxa, CHAINS, device="cuda", kind="banded",
                                       bandwidth=BANDWIDTH)
        _BANDED[n_taxa] = (model, batch, time.perf_counter() - t0)
    return _BANDED[n_taxa]


def _densified(B3, D):
    """The ``[D, D]`` matrix whose block-tridiagonal form is ``B3`` (for the
    library's time)."""
    import torch

    nb, _, wb, _ = B3.shape
    M = torch.zeros(((nb + 2) * wb, (nb + 2) * wb), dtype=B3.dtype, device=B3.device)
    for n in range(nb):
        for o in range(3):
            M[(n + 1) * wb:(n + 2) * wb, (n + o) * wb:(n + o + 1) * wb] = B3[n, o]
    return M[wb:wb + D, wb:wb + D].contiguous()


def _band_terms(nb, upper):
    """The block products of one whole call (each reads one distinct ``wb x
    wb`` block of ``B3``)."""
    return sum(1 for m in range(nb) for o in range(1 if upper else 0, 3) if 0 <= m + 1 - o < nb)


def _band_steps(model):
    """The banded z update's largest likelihood range block and largest
    point step of the model's FastSweeps plan: ``(what, rows, ok)`` each,
    rows and validity of the step's row slots as ``FastSweeps`` trims and
    builds them (``d_flat``)."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.fast_sweep import plan_batches, step_tensors

    table = P.build_proposal_table(model.topo, model.braces, False)
    plan = plan_batches(model, table)
    pos = np.asarray(model.topo.internal_pos, np.int64)
    best = {}
    for key, spec in list(plan.range_specs.items()) + list(plan.specs.items()):
        kind = key[0] if isinstance(key, tuple) else key
        if kind in (P.K_SCALE_SUBTREES_CONTRA, P.K_SLIDE_NODES_CONTRA):
            continue
        what = "range block" if isinstance(key, tuple) else "point step"
        for sx in step_tensors(spec, "cpu", torch.float32):
            own = (sx["own"] if "own" in sx else sx["d_rows"]).reshape(-1).numpy()
            ok = own >= 0
            if "own" in sx:
                rows = np.where(ok, pos[np.maximum(own, 0)], 0)
            else:
                rows = np.maximum(own, 0)
            if what not in best or ok.sum() > best[what][2].sum():
                best[what] = (what, rows, ok)
    return [best[k] for k in ("range block", "point step")]


def _rows_dense(prows, plan, n, D):
    """The ``[n, D]`` precision rows of a plan's row slots (zero on pad
    slots), densified from the row band: the library call's operand."""
    import torch

    w = plan.w
    rows = plan.rows.long()
    cols = rows[:, None] - w + torch.arange(2 * w + 1, device=rows.device)[None]
    keep = (cols >= 0) & (cols < D)
    out = torch.zeros((n, D), dtype=prows.dtype, device=prows.device)
    out[plan.slots.long()[:, None].expand_as(cols)[keep], cols[keep]] = prows[rows][keep]
    return out


def _band_rows_record(n_taxa, model, pband, P3):
    """band_rows_add on the banded model's largest range block and largest
    point step against its plain version, within K2_REL of the largest
    output; the range block's kernel timed flushed beside the
    scatter-and-window path it replaced (``index_add_`` of dacc into a zero
    buffer, B1 on the rows' window ``into`` z, ``index_fill_``), in turns,
    and beside ``z.addmm_(dacc, Prow)`` with the block's densified rows.
    Bound: z over the plan's tiles read and written, dacc's valid columns,
    the rows' bands and the plan read once; 2 C operations per (row, column
    in its band)."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.kernels.band_matmul import ROWS_TILE, band_matmul, band_rows_add, \
        band_rows_add_plain, band_rows_plan
    from mcmcdate_tpu_torch.ops import banded

    D = model.likelihood.dim
    w = pband.shape[1] - 1
    nb, _, wb, _ = P3.shape
    prows = torch.as_tensor(banded.rows_from_sym_band(pband), dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(n_taxa + 19)
    z0 = torch.randn((CHAINS, D), generator=g, device="cuda")
    worst, rec = 0.0, None
    for what, rows, ok in _band_steps(model):
        plan = band_rows_plan(rows, ok, w, D, device="cuda")
        dacc = 1e-2 * torch.randn((CHAINS, len(rows)), generator=g, device="cuda")
        zk, zp = z0.clone(), z0.clone()
        before = band_rows_add.launches
        band_rows_add(zk, dacc, prows, plan)
        band_rows_add_plain(zp, dacc, prows, plan)
        _sync()
        check(band_rows_add.launches == before + 1, "band_rows_add: not one launch a call")
        err = float((zk - zp).abs().max())
        scale = float(zp.abs().max())
        check(err <= K2_REL * max(scale, 1.0),
              f"band_rows_add {what} at {n_taxa} taxa: max error {err:.3g} at scale {scale:.3g}")
        worst = max(worst, err)
        tiles, nnz, k = plan.col0.numel(), plan.ent.shape[0], int(ok.sum())
        reach = int(np.sum(np.minimum(rows[ok] + w, D - 1) - np.maximum(rows[ok] - w, 0) + 1))
        log(f"[band] band_rows_add {what} at {n_taxa} taxa: {k} rows of {len(rows)} slots, "
            f"{tiles} tiles of {ROWS_TILE} columns (of D = {D}), "
            f"{nnz} (row, tile) entries; max error {err:.3g} at scale {scale:.3g}")
        if what != "range block":
            continue
        # The parent's three launches, on the same z, dacc and rows.
        d_flat = torch.as_tensor(rows, dtype=torch.int32, device="cuda")
        d_flat64 = d_flat.long()
        win = banded.block_window(int(rows[ok].min()), int(rows[ok].max()) + 1, wb, nb)
        buf = torch.zeros_like(z0)
        dz = torch.where(torch.as_tensor(ok, device="cuda"), dacc, 0.0)

        def scatter_window():
            buf.index_add_(1, d_flat, dz)
            band_matmul(buf, P3, window=win, into=zk)
            buf.index_fill_(1, d_flat64, 0.0)

        zo = z0.clone()
        buf.index_add_(1, d_flat, dz)
        band_matmul(buf, P3, window=win, into=zo)
        buf.index_fill_(1, d_flat64, 0.0)
        _sync()
        err_old = float((zo - zp).abs().max())
        check(err_old <= K2_REL * max(scale, 1.0),
              f"the scatter-and-window z update at {n_taxa} taxa: max error {err_old:.3g}")
        ms, old_ms = [], []
        for order in (0, 1, 1, 0):
            if order == 0:
                ms.append(_device_ms(lambda: band_rows_add(zk, dacc, prows, plan),
                                     only="band_rows_kernel", flush=True))
            else:
                old_ms.append(_device_ms(scatter_window, only=("band_kernel", "ndex"), flush=True))
        plain_ms = _device_ms(lambda: band_rows_add_plain(zp, dacc, prows, plan))
        Prow = _rows_dense(prows, plan, len(rows), D)
        lib_ms = _device_ms(lambda: zk.addmm_(dacc, Prow), only=("gemm", "splitK"), flush=True)
        del Prow
        cols = int(sum(min(j + ROWS_TILE, D) - j for j in plan.col0.tolist()))
        nbytes = (4 * (2 * CHAINS * cols + CHAINS * k + len(np.unique(rows[ok])) * (2 * w + 1))
                  + 4 * (2 * nnz + tiles + tiles + 1))
        rec = _record(0.0, sum(ms) / 2, plain_ms, nbytes, 2 * CHAINS * reach, lib_ms)
        rec["three_launch_ms"] = sum(old_ms) / 2
        rec["readings"] = dict(kernel=ms, three_launch=old_ms)
        log(f"[band] band_rows_add range block at {n_taxa} taxa, flushed, in turns: kernel "
            f"{ms[0]:.4f} / {ms[1]:.4f} ms, the scatter-and-window path (index_add_ + windowed "
            f"B1 {win} + index_fill_) {old_ms[0]:.4f} / {old_ms[1]:.4f} ms; z.addmm_(dacc, Prow) "
            f"{lib_ms:.4f} ms; plain {plain_ms:.4f} ms; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}: {cols} z columns, {reach} (row, column) pairs)")
    rec["max_abs_err"] = worst
    return rec


def check_band(n_taxa):
    """B1 ``band_matmul`` and B2 ``band_matmul_t`` against their plain
    versions on the synthetic banded model's own blocks, ``L3`` (upper) and
    ``P3``, at the shapes of every site of the banded sweep: the whitened
    residual ``(d - mu) L``, a sequential ticket's ``dy = delta L`` on its
    window with its rows and ``y``, the glob families' ``delta @ P`` whole
    and on a subtree's window, the windowed ``into`` product and ``z = y
    L^T``; within K2_REL of the largest output.  Records: B1 on the whole
    ``delta @ P``, B2 on ``z = y L^T``, each timed flushed in turns with
    ``torch.matmul`` with the densified matrix, flushed too (kernel,
    library, library, kernel); and band_rows_add (``_band_rows_record``)."""
    import torch

    from mcmcdate_tpu_torch.kernels.band_matmul import band_matmul, band_matmul_plain, \
        band_matmul_t, band_matmul_t_plain
    from mcmcdate_tpu_torch.ops import banded
    from mcmcdate_tpu_torch.ops.heights import distances_internal

    model, batch, build_s = _banded_model(n_taxa)
    s = _perturbed(model, batch, 5)
    L3 = model.band_L3_internal_t
    nb, _, wb, _ = L3.shape
    pband = banded.pband_from_chol_upper(model.likelihood.band_chol)
    P3 = torch.as_tensor(banded.blocks_from_sym_band(pband, wb), dtype=torch.float32,
                         device="cuda")
    D, mu = model.likelihood.dim, model.mu_internal_t
    d = distances_internal(s, model.topo).contiguous()
    y = band_matmul_plain(d, L3, sub=mu)[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    delta = (0.01 * d * torch.randn(d.shape, generator=g, device="cuda")).contiguous()
    lo, hi = D // 3, min(D // 3 + 300, D)
    keep = torch.zeros(D, dtype=torch.bool, device="cuda")
    keep[lo:hi] = True
    dspan = torch.where(keep, delta, 0.0).contiguous()
    win_l, win_p = (banded.block_window(lo, hi, wb, nb, upper=True),
                    banded.block_window(lo, hi, wb, nb))
    cases = (
        ("band_matmul", "(d - mu) L", L3, dict(x=d, sub=mu, upper=True)),
        ("band_matmul", "ticket dy", L3, dict(x=delta, y=y, upper=True, window=win_l,
                                              x_rows=(lo, hi))),
        ("band_matmul", "delta P", P3, dict(x=delta)),
        ("band_matmul", "subtree delta P", P3, dict(x=dspan, window=win_p)),
        ("band_matmul", "into", P3, dict(x=dspan, window=win_p, into=y)),
        ("band_matmul_t", "z = y L^T", L3, dict(x=y, upper=True)),
        ("band_matmul_t", "windowed, y", L3, dict(x=dspan, y=y, upper=True, window=win_l)),
        ("band_matmul_t", "P^T, sub", P3, dict(x=d, sub=mu)),
    )
    fns = {"band_matmul": (band_matmul, band_matmul_plain),
           "band_matmul_t": (band_matmul_t, band_matmul_t_plain)}
    worst = {k: 0.0 for k in fns}
    for name, what, B3, kw in cases:
        fn, plain = fns[name]
        kk, kp = dict(kw), dict(kw)
        if "into" in kw:
            kk["into"], kp["into"] = kw["into"].clone(), kw["into"].clone()
        ok, rk = fn(B3=B3, **kk)
        op, rp = plain(B3=B3, **kp)
        _sync()
        pairs = (("out", ok, op),) + ((("reduction", rk, rp),) if rp is not None else ())
        for part, a, b in pairs:
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(err <= K2_REL * max(scale, 1.0),
                  f"{name} {what} {part} at {n_taxa} taxa: max error {err:.3g} at scale "
                  f"{scale:.3g}")
            worst[name] = max(worst[name], err)
    C = d.shape[0]
    out = {}
    for name, B3, upper, x in (("band_matmul", P3, False, delta), ("band_matmul_t", L3, True, y)):
        fn, plain = fns[name]
        M = _densified(B3, D)
        Mx = M.t() if name == "band_matmul_t" else M
        ms, lib = [], []
        for order in (0, 1, 1, 0):
            if order == 0:
                ms.append(_device_ms(lambda: fn(x, B3, upper=upper),
                                     only=("band_kernel", "band_reduce"), flush=True))
            else:
                lib.append(_device_ms(lambda: torch.matmul(x, Mx), only=("gemm", "splitK"),
                                      flush=True))
        lib_warm = _device_ms(lambda: torch.matmul(x, Mx))
        plain_ms = _device_ms(lambda: plain(x, B3, upper=upper))
        del M, Mx
        terms = _band_terms(nb, upper)
        # Bytes: x and each block read once, the product and the per-chain
        # sum written once.  Operations: the block products formed.
        nbytes = 4 * (2 * C * D + terms * wb * wb + C)
        out[name] = _record(worst[name], sum(ms) / 2, plain_ms, nbytes,
                            2 * C * terms * wb * wb, sum(lib) / 2)
        out[name]["readings"] = dict(kernel=ms, library=lib, library_warm=lib_warm)
        log(f"[band] {name} at {n_taxa} taxa, whole product, flushed, in turns: kernel "
            f"{ms[0]:.4f} / {ms[1]:.4f} ms, cuBLAS on the densified matrix {lib[0]:.4f} / "
            f"{lib[1]:.4f} ms (back to back {lib_warm:.4f})")
    out["band_rows_add"] = _band_rows_record(n_taxa, model, pband, P3)
    log(f"[band] at {n_taxa} taxa: D = {D}, wb = {wb}, nb = {nb}; the synthetic banded model "
        f"built in {build_s:.1f} s; {len(cases)} cases ({', '.join(w for _, w, _, _ in cases)}) "
        f"within K2_REL of their plain versions")
    return out


# ---------------------------------------------------------------------------
# NUTS: H1-H3 and the gradient product
# ---------------------------------------------------------------------------

# Operations per node that H1's function needs, counted from the terms'
# expressions (csrc/device_math.cuh): a de_factors is 16 operations (a
# transcendental counted as one), an inner node's birth-death term two of
# them and 2 more, a leaf's one and 2 more, in float64 as K1 evaluates
# them; the UncorrelatedGamma clock term of a branch 5 in float32 (its
# shape's terms are the chain's); the gradient by reverse mode at 2
# operations a value operation (a local partial, an accumulation), so 3
# times the value's.
NUTS_F64_BD_INNER = 3 * (2 * 16 + 2)
NUTS_F64_BD_LEAF = 3 * (16 + 2)
NUTS_F32_CLOCK = 3 * 5


def _nuts_setup(model, batch, depth, eps, beta, seed):
    """A NutsMove of ``depth`` doublings on a perturbed state of ``batch``,
    with an inverse mass from the chains' coordinate variances; returns
    ``(move, state, q0, inv_mass, args)``."""
    import torch

    from mcmcdate_tpu_torch.engine import hmc

    mv = hmc.NutsMove(model, depth)
    s = _perturbed(model, batch, seed)
    q0 = mv.coords.to_vector(s)
    inv_mass = (q0.var(dim=0) + 1e-4).contiguous()
    C = q0.shape[0]
    w = mv.work(C, torch.float32, q0.device)
    bp = torch.ones(C, device="cuda")
    return mv, s, q0, inv_mass, (mv.nc, w, s, eps, inv_mass, beta, bp)


def _nuts_checked(name, model, batch, depth, eps, beta, seed):
    """One trajectory per chain with every launch replayed through the
    plain versions (``NutsCheck``); returns the check and the mean steps."""
    import torch

    from mcmcdate_tpu_torch.engine import hmc
    from mcmcdate_tpu_torch.kernels.nuts_step import NutsCheck

    mv, s, q0, inv_mass, args = _nuts_setup(model, batch, depth, eps, beta, seed)
    C, dim = q0.shape
    chk = NutsCheck(args[1], mv.coords)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = hmc.NutsDraws(gen, C, dim, torch.float32, "cuda")
    _, astat, n = mv.trajectory(s, q0, eps, inv_mass, draws, beta_lik=beta, check=chk)
    _sync()
    check(bool(torch.isfinite(astat).all()), f"{name}: acceptance statistics not finite")
    check(chk.compared > 2 and int(n.max()) > 1, f"{name}: a trajectory of {int(n.max())} steps")
    return chk, float(n.float().mean())


def check_nuts(n_taxa):
    """H1, H2 and H3 against their plain versions on the card: whole
    trajectories of up to NUTS_DEPTH doublings at ``n_taxa`` x CHAINS on the
    synthetic full model with node priors (every launch replayed from the
    kernels' state: ``kernels.nuts_step.NutsCheck``'s CHECK_TOL and
    decisions equal up to ties), with the 128-point ladder tiled over the
    chains as β_lik, from a perturbed state (near-critical chains, the
    Stirling branch of the clock); at MAIN_TAXA also under the univariate
    kind and, through B1, the banded kind, each reaching NUTS_MIN_DEPTH.
    Records: each kernel timed flushed on one leaf (H1 forward, H2 on leaf
    1 with its one U-turn check, H3 after a doubling), the plain version
    back to back, and the product ``z = r P`` (cuBLAS) beside the float64
    product, its error against it."""
    import dataclasses

    import numpy as np
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.kernels import nuts_step as NS
    from mcmcdate_tpu_torch.ops import mvn

    cal, con, br = _node_priors(synthetic.build(n_taxa, 1, device="cuda")[0].topo)
    model, batch = synthetic.build(n_taxa, CHAINS, device="cuda", calibrations=cal,
                                   constraints=con, braces=br)
    beta = _ladder(CHAINS)
    worst = {"prologue": 0.0, "epilogue": 0.0, "merge": 0.0}
    cases = [("full, node priors", model, batch)]
    if n_taxa == MAIN_TAXA:
        rng = np.random.default_rng(3)
        uni = dataclasses.replace(model, likelihood=mvn.LikelihoodData.univariate(
            model.likelihood.mu, rng.uniform(1e-3, 1e-2, model.likelihood.dim)))
        bm, bb, _ = _banded_model(n_taxa)
        cases += [("univariate", uni, batch), ("banded", bm, bb)]
    notes = []
    check(NUTS_DEPTH == NS.MAX_DEPTH, "NUTS_DEPTH is not the kernels' MAX_DEPTH")
    for what, m, b in cases:
        b1 = NS.nuts_leapfrog_prologue.launches
        chk, steps = _nuts_checked(f"nuts {what} at {n_taxa} taxa", m, b, NUTS_DEPTH,
                                   NUTS_EPS[n_taxa], beta, 11)
        for k in worst:
            worst[k] = max(worst[k], chk.err[k])
        errs = {k: float(f"{v:.3g}") for k, v in chk.field_err.items()}
        notes.append(f"{what}: {chk.compared} launches replayed, deepest {chk.depth} "
                     f"doublings, {chk.ties} take ties, {chk.turn_ties} U-turn ties, mean "
                     f"{steps:.2f} steps, errors by field {json.dumps(errs)}")
        check(NS.nuts_leapfrog_prologue.launches > b1, f"nuts {what}: H1 never launched")
        check(chk.depth >= NUTS_MIN_DEPTH,
              f"nuts {what}: the deepest checked trajectory doubled {chk.depth} times")
    log(f"[nuts] at {n_taxa} taxa x {CHAINS} chains, depth up to {NUTS_DEPTH}, eps "
        f"{NUTS_EPS[n_taxa]}, the ladder as beta_lik: " + "; ".join(notes))

    # Timings on the full model: an init, then one forward leaf.
    mv, s, q0, inv_mass, args = _nuts_setup(model, batch, NUTS_DEPTH, NUTS_EPS[n_taxa], beta,
                                            12)
    w = args[1]
    C, dim = q0.shape
    N, D = model.topo.n, model.likelihood.dim
    dirs = torch.ones(C, dtype=torch.bool, device="cuda")
    u = torch.full((C,), 0.5, device="cuda")
    w.q_new.copy_(q0)
    NS.nuts_leapfrog_prologue(*args, normals=torch.randn(C, dim, device="cuda"))
    mv.product(w)
    NS.nuts_leapfrog_epilogue(*args)
    for leaf in (0, 1):
        NS.nuts_leapfrog_prologue(*args, dirs=dirs)
        mv.product(w)
        if leaf == 0:
            NS.nuts_leapfrog_epilogue(*args, dirs=dirs, u_leaf=u, leaf=0)
    # Every chain active in the timed leaf: a chain that turned or diverged
    # at leaf 0 skips H1 and H2 and would flatter their times.
    done = int((w.stop | w.trn | w.div).sum())
    for k in ("stop", "trn", "div"):
        getattr(w, k).zero_()
    scal = ("n_steps", "sum_acc", "lw_sub", "trn", "div", "stop", "depth", "log_w", "logp",
            "dh")
    saved = {k: getattr(w, k).clone() for k in scal}

    def restored(fn):
        def run():
            for k, v in saved.items():
                getattr(w, k).copy_(v)
            fn()
        return run

    h1 = lambda: NS.nuts_leapfrog_prologue(*args, dirs=dirs)  # noqa: E731
    h2 = lambda: NS.nuts_leapfrog_epilogue(*args, dirs=dirs, u_leaf=u, leaf=1)  # noqa: E731
    h3 = lambda: NS.nuts_merge(w, inv_mass, u)  # noqa: E731
    times = {
        "prologue": (_device_ms(h1, only="nuts_prologue_kernel", flush=True),
                     _device_ms(lambda: NS.nuts_leapfrog_prologue_plain(*args, dirs=dirs))),
        "epilogue": (_device_ms(restored(h2), only="nuts_epilogue_kernel", flush=True),
                     _device_ms(restored(lambda: NS.nuts_leapfrog_epilogue_plain(
                         *args, dirs=dirs, u_leaf=u, leaf=1)))),
        "merge": (_device_ms(restored(h3), only="nuts_merge_kernel", flush=True),
                  _device_ms(restored(lambda: NS.nuts_merge_plain(w, inv_mass, u)))),
    }
    # The product by CUDA events over REPS back-to-back calls (a profile of
    # it can miss calls: one read 0.1146 ms at 1000 taxa, below the float32
    # bound, where events read 0.1768), and each kernel's back-to-back
    # events time beside its flushed profile, in the log; its error against
    # the float64 product on the same r.
    prod_ms = _event_ms(lambda: mv.product(w))
    mv.product(w)
    r64, p64 = w.r.double(), mv.P.double()
    z64 = r64 @ p64
    prod_err = float((w.z.double() - z64).abs().max() / z64.abs().max())
    prod64_ms = _event_ms(lambda: torch.mm(r64, p64))
    log(f"[nuts] at {n_taxa} taxa, timed on a leaf of all {C} chains ({done} had turned or "
        f"diverged at leaf 0), back to back by CUDA events (ms a call): H1 "
        f"{_event_ms(h1):.4f}, H2 {_event_ms(restored(h2)):.4f} (with its scalars' restore), "
        f"H3 {_event_ms(restored(h3)):.4f}, the product {prod_ms:.4f} (float64 {prod64_ms:.4f})")
    n_inner = int((~np.asarray(model.topo.is_leaf)).sum()) - 1
    n_leaf = N - 1 - n_inner
    # The state's entries that are not coordinates (the tips' and the
    # root's heights, the height when not calibrated), read by H1 and H2.
    fixed = C * (N - len(mv.coords.height_idx)) + (0 if mv.coords.calibrated else C)
    f4 = 4
    # Bytes the functions must move: each input read once, each output
    # written once.  H1: the moving end's q, p, g, the fixed state entries,
    # mu and the inverse mass in; q', p_half, the gradient, r and lp, jac
    # out.  H2 (leaf 1, one U-turn check): q', p_half, the gradient, r, z,
    # the fixed state entries, one checkpoint's q and p, the inverse mass
    # and the per-chain scalars in; the end's q, p, g and the per-chain
    # scalars out.  H3: both ends' q and p in, the flags and weights out (no
    # replace: u = 0.5 of equal weights keeps the proposal).  Operations:
    # H1 the drift (5 a coordinate), the distances and r (4 an entry), the
    # terms and their gradient (NUTS_*); H2 r.z, the distances' transposed
    # Jacobian (5 an entry), the kick, the kinetic energy and two U-turn
    # dot products (12 a coordinate); H3 two dot products (7 a coordinate).
    b1 = f4 * (3 * C * dim + fixed + D + dim + 3 * C * dim + C * D + 2 * C)
    ops1 = C * (5 * dim + 4 * D + (N - 1) * NUTS_F32_CLOCK)
    ops64 = C * (n_inner * NUTS_F64_BD_INNER + n_leaf * NUTS_F64_BD_LEAF)
    b2 = f4 * (3 * C * dim + 2 * C * D + fixed + 2 * C * dim + dim + 8 * C + 3 * C * dim + 8 * C)
    b3 = f4 * (4 * C * dim + dim + 6 * C)
    out = {}
    for name, key, nbytes, ops, o64 in (
            ("nuts_leapfrog_prologue", "prologue", b1, ops1, ops64),
            ("nuts_leapfrog_epilogue", "epilogue", b2, C * (5 * D + 12 * dim), 0),
            ("nuts_merge", "merge", b3, 7 * C * dim, 0)):
        out[name] = _record(worst[key], times[key][0], times[key][1], nbytes, ops, None, o64)
        log(f"[nuts] {name} at {n_taxa} taxa: {nbytes} bytes ({nbytes / PEAK_BYTES * 1e3:.4f} "
            f"ms), {ops} float32 and {o64} float64 operations "
            f"({(ops / PEAK_F32 + o64 / PEAK_F64) * 1e3:.4f} ms)")
    # The product, a library call and not a hand-written kernel: r and P
    # read, z written; 2 C D^2 float32 operations; "plain_ms" the float64
    # product's time.
    out["nuts_product"] = _record(prod_err, prod_ms, prod64_ms, f4 * (2 * C * D + D * D),
                                  2 * C * D * D, prod_ms)
    return out


# Each check returns its kernels' records by kernel name.
def _fiber_classes(fs):
    """The fiber plan's colour classes of FastSweeps ``fs``'s model on the
    card (as a FastSweeps built with ``fiber_slide`` holds them)."""
    from mcmcdate_tpu_torch.engine.fast_sweep import fiber_slide_plan
    from mcmcdate_tpu_torch.kernels.fiber_slide import FiberClass

    T = sum(fs.model.term_block_sizes)
    return [FiberClass.of(c, T, "cuda") for c in fiber_slide_plan(fs.model)]


def _check_fiber_slide(n_taxa, beta_prior=None):
    """F1 on each colour class in turn (a whole phase) against its plain
    version, on the model with node priors, each chain's decisions at its
    ``beta_prior`` (``[C]``; None: 1): the kernel's decisions replayed
    through the plain version (every decision taken as the kernel took it),
    whose log alpha must give the kernel's decisions except at ties
    (|log u - log alpha| < SCAN_TIE) and whose proposals, heights and rates
    must equal the kernel's bitwise and terms within CONTRA_REL (1 + |x|);
    the accept count the kernel summed; every branch distance kept; the
    kernel's terms against a fresh evaluation.  Each class timed flushed,
    its plain version by PLAIN_REPS calls (without ``beta_prior`` only).
    Returns the record (per launch: the mean over the classes; plain_ms
    None with ``beta_prior``) and the number of accepts."""
    import torch

    from mcmcdate_tpu_torch.kernels.fiber_slide import fiber_slide, fiber_slide_plain
    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms_plain

    fs, carry, _, gen = _glob_fast(n_taxa)
    model = fs.model
    classes = _fiber_classes(fs)
    ck, cr = _copy_carry(carry), _copy_carry(carry)
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    worst = {"log_alpha": 0.0, "terms": 0.0}
    n_acc = n_tie = n_pairs = n_bits = 0
    ms = plain_ms = nbytes = ops = ops64 = 0.0
    par, nr = model.topo.parent_t, model.topo.non_root_t

    def lengths(st):
        h, r = st.heights, st.rates
        return (torch.where(nr, (h[:, par] - h) * r, 0.0),
                torch.where(nr, (h[:, par].abs() + h.abs()) * r.abs(), 0.0))

    (l0, m0) = lengths(carry.batch)
    for cls in classes:
        u = torch.empty((CHAINS, cls.m), device="cuda").uniform_(1e-6, 1.0, generator=gen)
        u_acc = torch.rand((CHAINS, cls.m), generator=gen, device="cuda")
        ok = fiber_slide(model, ck.batch, ck.terms, cls, u, u_acc, beta_prior, count)
        forced = torch.where(ok.accept, 0.0, math.nan)
        orr = fiber_slide_plain(model, cr.batch, cr.terms, cls, u, forced, beta_prior)
        _sync()
        name = f"fiber_slide class of {cls.m} nodes at {n_taxa} taxa"
        check(torch.equal(orr.accept, ok.accept),
              f"{name}: the kernel accepted where the plain log alpha is -inf or NaN")
        check(_same(ok.h_new, orr.h_new), f"{name}: proposals differ from the plain ones")
        logu = torch.log(u_acc)
        differ = (logu < orr.log_alpha) != ok.accept
        gap = (logu - orr.log_alpha).abs()[differ]
        check(bool((gap < SCAN_TIE).all()), lambda: f"{name}: {int(differ.sum())} decisions "
              f"differ beyond ties (largest |log u - log alpha| {float(gap.max()):.3g})")
        fin = torch.isfinite(orr.log_alpha)
        check(torch.equal(fin, torch.isfinite(ok.log_alpha)),
              f"{name}: log alpha finiteness differs")
        err = (ok.log_alpha - orr.log_alpha).abs()[fin]
        worst["log_alpha"] = max(worst["log_alpha"], float(err.max()) if err.numel() else 0.0)
        for what in ("heights", "rates"):
            check(_same(getattr(ck.batch, what), getattr(cr.batch, what)),
                  f"{name}: {what} differ from the replay's")
        fin = torch.isfinite(cr.terms)
        check(torch.equal(fin, torch.isfinite(ck.terms)), f"{name}: terms finiteness differs")
        err = (ck.terms - cr.terms).abs()[fin]
        worst["terms"] = max(worst["terms"], float(err.max()))
        check(bool((err <= CONTRA_REL * (1 + cr.terms.abs()[fin])).all()),
              f"{name}: terms off the replay's by {worst['terms']:.3g}")
        n_bits += int((ck.terms.nan_to_num() != cr.terms.nan_to_num()).sum())
        n_acc += int(ok.accept.sum())
        n_tie += int(differ.sum())
        n_pairs += ok.accept.numel()
        # The class's cost: per (chain, node) its draws, heights of the node,
        # parent and children, rates of the node and children, owned terms
        # in, the decision out, and for accepts the same out; per chain its
        # five scalars; the plan.  Operations: about 60 a term (special
        # functions counted as 10) and 100 in double per birth-death term.
        ptr = cls.own_ptr.cpu().numpy()
        E = int(ptr[-1])
        KC = cls.ch.shape[1]
        n_bd = int(((cls.own_rows >= 4) & (cls.own_rows < 4 + model.topo.n)).sum())
        acc_terms = float((ok.accept.float() * torch.as_tensor(
            ptr[1:] - ptr[:-1], device="cuda", dtype=torch.float32)).sum())
        nbytes += (4 * CHAINS * (cls.m * (5 + 2 * KC) + E) + 9 * CHAINS * cls.m
                   + 4 * (int(ok.accept.sum()) * (2 + KC) + acc_terms) + 20 * CHAINS
                   + 4 * (cls.m * (3 + KC) + E))
        ops += CHAINS * (60 * E + 30 * cls.m)
        ops64 += 100 * CHAINS * n_bd
        c1 = _copy_carry(carry)
        ms += _device_ms(lambda: fiber_slide(model, c1.batch, c1.terms, cls, u, u_acc,
                                             beta_prior),
                         only="fiber_slide_kernel", flush=True)
        if beta_prior is None:
            c2 = _copy_carry(carry)
            plain_ms += _device_ms(lambda: fiber_slide_plain(model, c2.batch, c2.terms, cls, u,
                                                             u_acc), reps=PLAIN_REPS)
    check(int(count) == n_acc, f"fiber_slide: the kernel counted {int(count)} accepts of {n_acc}")
    check(0 < n_acc < n_pairs, f"fiber_slide at {n_taxa} taxa: {n_acc} accepts of {n_pairs}")
    l1, _ = lengths(ck.batch)
    worst["distances"] = float(((l1 - l0).abs() / m0.clamp(min=1e-30)).max())
    check(worst["distances"] <= CONTRA_REL, f"fiber_slide: a branch distance moved by "
          f"{worst['distances']:.3g} of its heights' products")
    direct = prior_terms_plain(model, ck.batch)
    fin = torch.isfinite(direct)
    check(torch.equal(fin, torch.isfinite(ck.terms)), "fiber_slide: fresh terms finiteness")
    err = (ck.terms[fin] - direct[fin]).abs()
    worst["fresh_terms"] = float(err.max())
    check(bool((err <= CONTRA_REL * (1 + direct[fin].abs())).all()),
          f"fiber_slide: terms off a fresh evaluation by {worst['fresh_terms']:.3g}")
    k = len(classes)
    rec = _record(max(worst["log_alpha"], worst["terms"]), ms / k, plain_ms / k, nbytes / k,
                  ops / k, ops64=ops64 / k)
    at, plain = (("at beta_prior 1", f"plain {plain_ms:.4f} ms, ") if beta_prior is None
                 else ("with the MC3 ladder as beta_prior", ""))
    log(f"[kernels] fiber_slide at {n_taxa} taxa x {CHAINS} chains {at}: {k} colour classes "
        f"({[c.m for c in classes]} nodes), one launch each: {ms:.4f} ms a phase "
        f"({plain}bound {_bound(nbytes, ops, ops64)[0]:.4f} ms); "
        f"{n_acc} accepts of {n_pairs} ({n_acc / n_pairs:.3f}), {n_tie} tie decisions differ "
        f"from the replay, {n_bits} terms not bitwise equal to it; largest differences "
        f"{json.dumps(worst)}")
    if beta_prior is not None:
        rec["plain_ms"] = None
    return rec, n_acc


def _de_ensemble(model, batch, seed):
    """An ensemble near one state, as the chains of a run near equilibrium
    are: every chain takes chain 0's heights, then each inner node moves a
    random fraction (up to 1%) of the way to its parent, in pre-order (so
    every span stays positive); each chain keeps its own scalars and
    rates."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    C, N = batch.heights.shape
    h = batch.heights[:1].expand(C, N).clone()
    parent = model.topo.parent.tolist()
    leaf = model.topo.is_leaf.tolist()
    u = 0.01 * torch.rand((C, N), generator=g, device="cuda")
    for i in range(1, N):
        if not leaf[i]:
            h[:, i] += u[:, i] * (h[:, parent[i]] - h[:, i])
    return batch.replace(heights=h)


def _check_fiber_de(n_taxa):
    """F2 on the first half-update of a round against its plain version, on
    the model with node priors and an ensemble near one state
    (``_de_ensemble``, so that some proposals are accepted): the
    kernel's step against the plain one from the same draws (CUDA's exp
    against PyTorch's: within CONTRA_REL), then the plain version at the
    kernel's step with every decision taken as the kernel took it: its
    proposals bitwise the kernel's, its decisions the kernel's except at
    ties (|log u - dlp| < LP_REL (1 + |log prior|)), the chains' heights
    and rates bitwise the kernel's.  Timed flushed, the plain version by
    PLAIN_REPS calls.  Returns the record."""
    import torch

    from mcmcdate_tpu_torch.engine.ensemble import GAMMA_JITTER, GAMMA_JUMP, JUMP_P, FiberDE
    from mcmcdate_tpu_torch.kernels.fiber_de import fiber_de, fiber_de_plain
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    fs, carry, tuning, gen = _glob_fast(n_taxa)
    model = fs.model
    batch = _de_ensemble(model, carry.batch, n_taxa)
    de = FiberDE(model)
    h = CHAINS // 2
    draws = de.draws(gen, h, CHAINS - h, torch.float32, "cuda")
    args = (0, h, h, *draws, de.gamma_small, JUMP_P, GAMMA_JUMP, GAMMA_JITTER)
    name = f"fiber_de at {n_taxa} taxa"

    def copy():
        return State(**{f: getattr(batch, f).clone() for f in FIELDS})

    sk, sr, sp = copy(), copy(), copy()
    ok = fiber_de(model, sk, *args)
    op = fiber_de_plain(model, sp, *args)
    forced = torch.where(ok.accept, 0.0, math.nan)
    orr = fiber_de_plain(model, sr, *args[:7], forced, *args[8:], g=ok.g)
    _sync()
    worst = {}
    worst["g"] = float((ok.g - op.g).abs().max())
    check(bool(((ok.g - op.g).abs() <= CONTRA_REL * op.g.abs()).all()),
          f"{name}: steps off the plain ones by {worst['g']:.3g}")
    check(_same(ok.h_prop, orr.h_prop) and _same(ok.r_prop, orr.r_prop),
          f"{name}: proposals differ from the replay's")
    check(torch.equal(orr.accept, ok.accept), f"{name}: the kernel accepted an invalid proposal")
    lp = model.log_prior(State(**{f: getattr(batch, f)[:h] for f in FIELDS})).abs()
    logu = torch.log(draws[4])
    parent = model.topo.parent_t.clamp(min=0)
    valid = ((orr.h_prop[:, parent] - orr.h_prop)[:, 1:] > 1e-7).all(dim=1)
    differ = (valid & (logu < orr.dlp)) != ok.accept
    gap = (logu - orr.dlp).abs()
    check(bool((gap[differ] < LP_REL * (1 + lp[differ])).all()),
          lambda: f"{name}: {int(differ.sum())} decisions differ beyond ties")
    fin = torch.isfinite(orr.dlp)
    check(torch.equal(fin, torch.isfinite(ok.dlp)), f"{name}: dlp finiteness differs")
    worst["dlp"] = float((ok.dlp - orr.dlp).abs()[fin].max()) if fin.any() else 0.0
    worst["log_jac"] = float((ok.log_jac - orr.log_jac).abs()[fin].max()) if fin.any() else 0.0
    check(_same(sk.heights, sr.heights) and _same(sk.rates, sr.rates),
          f"{name}: the chains' states differ from the replay's")
    n_acc = int(ok.accept.sum())
    check(n_acc > 0, f"{name}: no accept of {h}")
    N = model.topo.n
    # Bytes: per active chain its and two donors' heights and its rates in
    # (16 N), the proposal out (8 N), an accepted chain's heights and rates
    # out (8 N), draws and outputs; per chain five scalars.  Operations:
    # per node and state its clock term (60) and in double its birth-death
    # term (100 each of the two D/E evaluations of an inner node, one of a
    # leaf), 30 for the proposal.
    n_inner = int((~model.topo.is_leaf_t).sum())
    nbytes = h * (24 * N + 8 * N * n_acc / h + 33 + 20)
    ops = h * N * (2 * 60 + 30)
    ops64 = h * 2 * 100 * (2 * n_inner + (N - n_inner))
    s1 = copy()
    ms = _device_ms(lambda: fiber_de(model, s1, *args), only="fiber_de_kernel", flush=True)
    s2 = copy()
    plain_ms = _device_ms(lambda: fiber_de_plain(model, s2, *args), reps=PLAIN_REPS)
    rec = _record(max(worst["dlp"], worst["g"]), ms, plain_ms, nbytes, ops, ops64=ops64)
    log(f"[kernels] {name} x {CHAINS} chains: a half-update of {h} chains, {n_acc} accepts, "
        f"{int(differ.sum())} tie decisions differ from the replay, proposals and states "
        f"bitwise equal to it; largest differences {json.dumps(worst)}")
    return rec


def check_fiber(n_taxa):
    """F1 (a whole fiber phase, class by class) and F2 (a half-update)
    against their plain versions; F1 again at each chain's prior
    temperature, the 4-rung MC3 ladder (``_mc3_ladder``) as under ``run
    --mc3``: its error, flushed time and accepts under F1's ``tempered``
    key, beside the time at beta_prior 1."""
    rec, _ = _check_fiber_slide(n_taxa)
    t, n_acc = _check_fiber_slide(n_taxa, _mc3_ladder(CHAINS))
    rec["tempered"] = dict(max_abs_err=t["max_abs_err"], ms=t["ms"], ms_untempered=rec["ms"],
                           accepts=n_acc)
    return {"fiber_slide": rec, "fiber_de": _check_fiber_de(n_taxa)}


def check_bold(n_taxa):
    """K6's range mode on the first block of each row bucket and G1 on the
    sub_contra family with the bold mixture's uniforms against their plain
    versions (``_contra_agree``, ``_glob_agree``), each timed with them and
    without them in turns (off, on, on, off) on copies of the carry; with
    every uniform above ``bold_p`` the kernels' states are bitwise those of
    the call without the uniforms.  Returns per kernel, named
    ``<kernel>_bold``, the largest difference from the plain version, the
    time with the uniforms (``ms``) and without them (``ms_off``)."""
    import torch

    from mcmcdate_tpu_torch.kernels import contra_step as K, glob_step as G

    out = {}
    fs, carry, tuning, gen = _fast(n_taxa)

    def bold_args(shape):
        return dict(u_bold=torch.rand(shape, generator=gen, device="cuda"), bold_p=BOLD_P,
                    bold_factor=BOLD_FACTOR)

    def in_turns(call):
        off1, on1 = call(False), call(True)
        on2, off2 = call(True), call(False)
        return (on1 + on2) / 2, (off1 + off2) / 2

    for step, rb, sx in _contra_steps(fs, "range"):
        u_prop, u_acc = _draws(fs, sx, tuning, gen, False)
        bold = bold_args(u_acc.shape)
        w, ok, _ = _contra_agree(f"contra_range {step} at {n_taxa} taxa with the bold mixture",
                                 "range", fs, carry, tuning, sx, u_prop, u_acc, bold)
        # Uniforms that never choose the bold kernel: bitwise the call without.
        c0, c1 = _copy_carry(carry), _copy_carry(carry)
        never = dict(bold, u_bold=torch.ones_like(u_acc))
        a0 = K.contra_range(c0.batch, c0.terms, c0.acc, tuning, sx, fs.model.topo.is_leaf_t,
                            fs.model.clock, u_prop, u_acc)
        a1 = K.contra_range(c1.batch, c1.terms, c1.acc, tuning, sx, fs.model.topo.is_leaf_t,
                            fs.model.clock, u_prop, u_acc, **never)
        _sync()
        check(torch.equal(a0.accept, a1.accept) and _same(c0.batch.heights, c1.batch.heights)
              and _same(c0.terms, c1.terms), f"contra_range {step}: never-bold uniforms change it")

        def call(on, sx=sx, u_prop=u_prop, u_acc=u_acc, bold=bold):
            c = _copy_carry(carry)
            return _device_ms(lambda: K.contra_range(
                c.batch, c.terms, c.acc, tuning, sx, fs.model.topo.is_leaf_t, fs.model.clock,
                u_prop, u_acc, **(bold if on else {})), only="contra_range_kernel")

        on, off = in_turns(call)
        out[f"contra_range_{rb}_bold"] = dict(max_abs_err=max(w["h_prop"], w["heights"]), ms=on,
                                              ms_off=off, accepts=int(ok.accept.sum()))
    gfs, gcarry, gtuning, ggen = _glob_fast(n_taxa)
    fam = gfs.glob_fam["sub_contra"]
    tun, draws, u = _glob_draws(fam, gtuning, ggen)
    bold = bold_args(u.shape)
    w, accept = _glob_agree(f"glob_scan sub_contra at {n_taxa} taxa with the bold mixture",
                            gfs, gcarry, fam, tun, draws, u, bold=bold)
    c0, c1 = _copy_carry(gcarry), _copy_carry(gcarry)
    G.glob_scan(gfs.glob, fam, c0, tun, draws, u)
    G.glob_scan(gfs.glob, fam, c1, tun, draws, u, **dict(bold, u_bold=torch.ones_like(u)))
    _sync()
    check(_same(c0.batch.heights, c1.batch.heights) and _same(c0.terms, c1.terms),
          "glob_scan sub_contra: never-bold uniforms change it")

    def gcall(on):
        c = _copy_carry(gcarry)
        return _device_ms(lambda: G.glob_scan(gfs.glob, fam, c, tun, draws, u,
                                              **(bold if on else {})), only="glob_scan_kernel")

    on, off = in_turns(gcall)
    out["glob_scan_bold"] = dict(max_abs_err=w["prop"], ms=on, ms_off=off, family="sub_contra",
                                 accepts=int(accept.sum()))
    for k, r in out.items():
        log(f"[kernels] {k} at {n_taxa} taxa: {r['ms']:.4f} ms with the bold uniforms, "
            f"{r['ms_off']:.4f} ms without (in turns), {100 * (r['ms'] / r['ms_off'] - 1):+.1f}%")
    return out


CHECKS = (check_prior_terms, check_whiten, check_ticket, check_point_step,
          check_range_step, check_prior_only_steps, check_contra_slide, check_contra_range,
          check_glob, check_cascade_seed, check_mc3_swap, check_fiber)


def phase_kernels():
    """Every kernel against its plain version at both shapes, the six
    decision kernels also tempered by the ladder (check_tempered); the
    record keeps the run's shape (136 taxa), the tempered times under
    ``tempered``."""
    results = {}
    for n_taxa in (MAIN_TAXA, BENCH_TAXA):
        t0 = time.perf_counter()
        tempered = check_tempered(n_taxa)
        log(f"[tempered] at {n_taxa} taxa x {CHAINS} chains: {json.dumps(tempered)} (check took "
            f"{time.perf_counter() - t0:.1f} s)")
        if n_taxa == MAIN_TAXA:
            results["tempered"] = tempered
        for fn in CHECKS:
            t0 = time.perf_counter()
            for name, r in fn(n_taxa).items():
                lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
                log(f"[kernels] {name} at {n_taxa} taxa x {CHAINS} chains: max error "
                    f"{r['max_abs_err']:.3g}, device time per call: kernel {r['ms']:.4f} ms, "
                    f"plain {r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}) (check took {time.perf_counter() - t0:.1f} s)")
                if n_taxa == MAIN_TAXA:
                    results[name] = r
        t0 = time.perf_counter()
        bold = check_bold(n_taxa)
        log(f"[kernels] the bold mixture at {n_taxa} taxa x {CHAINS} chains: {json.dumps(bold)} "
            f"(check took {time.perf_counter() - t0:.1f} s)")
        if n_taxa == MAIN_TAXA:
            results["bold"] = bold
        _FAST.pop(n_taxa, None)
        _GLOB.pop(n_taxa, None)
        _MODELS.pop(n_taxa, None)
    # H1-H3 and the product at both shapes; the record keeps the full
    # width's (its launches are that path's), the run's shape as record_136.
    nuts_136 = {}
    for n_taxa in (MAIN_TAXA, BENCH_TAXA):
        t0 = time.perf_counter()
        for name, r in check_nuts(n_taxa).items():
            log(f"[kernels] {name} at {n_taxa} taxa x {CHAINS} chains: max error "
                f"{r['max_abs_err']:.3g}, device time per call: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) (check "
                f"took {time.perf_counter() - t0:.1f} s)")
            if n_taxa == MAIN_TAXA:
                nuts_136[name] = r
            else:
                results[name] = dict(r, record_136=nuts_136[name])
    # B1 and B2 at the main path's and the banded full width's shapes; the
    # record keeps the full width's (its launches are that path's).
    for n_taxa in (MAIN_TAXA, BANDED_TAXA):
        t0 = time.perf_counter()
        for name, r in check_band(n_taxa).items():
            log(f"[kernels] {name} at {n_taxa} taxa x {CHAINS} chains: max error "
                f"{r['max_abs_err']:.3g}, device time per call: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) (check took "
                f"{time.perf_counter() - t0:.1f} s)")
            if n_taxa == MAIN_TAXA:
                results[f"{name}_136"] = r
            else:
                results[name] = dict(r, record_136=results.pop(f"{name}_136"))
    return results


def check_carried_posterior(runner, run_dir, lp_post, name="smoke", de=None):
    """The run's last log posterior per chain, which the sweep carries
    incrementally (prior terms replaced per accepted ticket, the whitened
    residual updated by K2's deltas), against a fresh float32 evaluation of
    the saved final state by the plain versions; and that float32
    evaluation against a float64 one of the same state (the model's float32
    rounding, not the carry's).  ``de``: the fiber-DE half-updates that ran
    in place after the last chunk, so after the trace's last draw
    (``_de_recorded``'s ``last``): a chain that one accepted must hold the
    proposal of its last accept, bitwise, and its carried log posterior
    gains each accept's log prior delta (``dlp - log_jac``; the likelihood
    is invariant).  Returns both errors."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import checkpoint as ckpt
    from mcmcdate_tpu_torch.tools.profile_sweep import direct_log_posterior

    state, _, _, _ = ckpt.load(name, in_dir=run_dir, device=runner.device)
    if de:
        lp_post = np.array(lp_post, dtype=np.float64)
        want_h = torch.full_like(state.heights, math.nan)
        want_r = torch.full_like(state.rates, math.nan)
        for act0, o in de:
            rows = act0 + torch.nonzero(o.accept).flatten()
            want_h[rows] = o.h_prop[o.accept]
            want_r[rows] = o.r_prop[o.accept]
            lp_post[act0:act0 + o.accept.numel()] += torch.where(
                o.accept, (o.dlp - o.log_jac).double(), 0.0).cpu().numpy()
        moved = ~torch.isnan(want_h[:, 0])
        check(_same(state.heights[moved], want_h[moved])
              and _same(state.rates[moved], want_r[moved]),
              f"{name}: the chains the last fiber-DE rounds moved do not hold their proposals")

    def direct(dtype):
        return direct_log_posterior(runner.model, state, dtype).double().cpu().numpy()

    d32 = direct(torch.float32)
    err = float(np.abs(d32 - lp_post).max())
    scale = float(np.abs(d32).max())
    check(err <= LP_REL * scale,
          f"carried log posterior is off the direct one by {err:.3g} at scale {scale:.3g}")
    err64 = float(np.abs(d32 - direct(torch.float64)).max())
    check(err64 <= LP_F64_REL * scale,
          f"float32 log posterior is off the float64 one by {err64:.3g} at scale {scale:.3g}")
    return err, err64


def _wrappers():
    from mcmcdate_tpu_torch.kernels.accept_select import accept_select
    from mcmcdate_tpu_torch.kernels.band_matmul import band_matmul, band_matmul_t, band_rows_add
    from mcmcdate_tpu_torch.kernels.cascade_seed import cascade_seed
    from mcmcdate_tpu_torch.kernels.contra_step import contra_range, contra_slide
    from mcmcdate_tpu_torch.kernels.fiber_de import fiber_de
    from mcmcdate_tpu_torch.kernels.fiber_slide import fiber_slide
    from mcmcdate_tpu_torch.kernels.glasso_admm import admm_eig_scale, admm_shift, admm_update
    from mcmcdate_tpu_torch.kernels.mc3_swap import mc3_swap
    from mcmcdate_tpu_torch.kernels.nuts_step import nuts_leapfrog_epilogue, \
        nuts_leapfrog_prologue, nuts_merge
    from mcmcdate_tpu_torch.kernels.glob_step import (
        glob_dense_epilogue,
        glob_dense_prologue,
        glob_scan,
    )
    from mcmcdate_tpu_torch.kernels.point_scan import point_scan
    from mcmcdate_tpu_torch.kernels.point_step import point_lik_epilogue, point_lik_prologue
    from mcmcdate_tpu_torch.kernels.prior_terms import prior_terms
    from mcmcdate_tpu_torch.kernels.range_scan import range_scan
    from mcmcdate_tpu_torch.kernels.range_step import range_lik_epilogue, range_lik_prologue
    from mcmcdate_tpu_torch.kernels.ticket_step import ticket_prologue, ticket_scan
    from mcmcdate_tpu_torch.kernels.whiten import whiten

    return {"prior_terms": prior_terms, "whiten": whiten, "ticket_prologue": ticket_prologue,
            "accept_select": accept_select, "ticket_scan": ticket_scan,
            "point_lik_prologue": point_lik_prologue, "point_scan": point_scan,
            "point_lik_epilogue": point_lik_epilogue, "range_lik_prologue": range_lik_prologue,
            "range_scan": range_scan, "range_lik_epilogue": range_lik_epilogue,
            "contra_slide": contra_slide, "contra_range": contra_range, "glob_scan": glob_scan,
            "glob_dense_prologue": glob_dense_prologue,
            "glob_dense_epilogue": glob_dense_epilogue, "admm_shift": admm_shift,
            "admm_eig_scale": admm_eig_scale, "admm_update": admm_update,
            "cascade_seed": cascade_seed, "band_matmul": band_matmul,
            "band_matmul_t": band_matmul_t, "band_rows_add": band_rows_add,
            "nuts_leapfrog_prologue": nuts_leapfrog_prologue,
            "nuts_leapfrog_epilogue": nuts_leapfrog_epilogue, "nuts_merge": nuts_merge,
            "mc3_swap": mc3_swap, "fiber_slide": fiber_slide, "fiber_de": fiber_de}


# The plain twins a wrapper takes for CPU tensors, by module: on the card a
# path calls none of them (``_counted`` counts them as ``plain_twins``).
PLAIN_TWINS = (
    ("accept_select", ("accept_select_plain",)),
    ("ticket_step", ("ticket_prologue_plain", "ticket_scan_plain")),
    ("point_scan", ("point_scan_plain",)),
    ("range_scan", ("range_scan_plain",)),
    ("glob_step", ("glob_family_plain", "glob_dense_prologue_plain",
                   "glob_dense_epilogue_plain")),
    ("cascade_seed", ("cascade_seed_plain",)),
    ("band_matmul", ("band_matmul_plain", "band_matmul_t_plain", "band_rows_add_plain")),
    ("nuts_step", ("nuts_leapfrog_prologue_plain", "nuts_leapfrog_epilogue_plain",
                   "nuts_merge_plain")),
    ("mc3_swap", ("mc3_swap_plain",)),
    ("fiber_slide", ("fiber_slide_plain",)),
    ("fiber_de", ("fiber_de_plain",)),
)


def _counted(run, inside=(), within=None):
    """Launch counts of every kernel during ``run()``, set to 0 just before
    it, with ``contra_range``'s also by row bucket (``contra_range_16``,
    ...) and ``ticket_scan``'s by kernel (``ticket_scan_light``: the warp
    per ticket runs; ``ticket_scan_heavy``: a CTA per chain); returns
    ``(counts, run's result)``.  The plain proposal kernels
    (``proposals.KERNELS``) are counted too, under ``plain_proposals``.
    ``inside`` names ``(class, method)`` pairs: the launch counts and plain
    proposals of their calls, and the calls, go to ``within[method]``.  The
    NUTS move's products ``z = r P`` are counted as ``nuts_product``."""
    from mcmcdate_tpu_torch.engine import hmc, proposals as P

    wrappers = _wrappers()
    by_rows = wrappers["contra_range"].launches_by_rows
    by_kind = wrappers["ticket_scan"].launches_by_kind
    for w in wrappers.values():
        w.launches = 0
    # The launches with the bold mixture's uniforms.
    wrappers["contra_range"].launches_bold = wrappers["glob_scan"].launches_bold = 0
    for rb in by_rows:
        by_rows[rb] = 0
    for k in by_kind:
        by_kind[k] = 0
    plain = [0]
    real_k = dict(P.KERNELS)

    def counting(fn):
        def k(*a, **kw):
            plain[0] += 1
            return fn(*a, **kw)
        return k

    def inside_of(real, acc):
        def wrapped(self, *a, **kw):
            before = {k: w.launches for k, w in wrappers.items()}
            p0 = plain[0]
            out = real(self, *a, **kw)
            for k, w in wrappers.items():
                acc[k] = acc.get(k, 0) + w.launches - before[k]
            acc["plain_proposals"] = acc.get("plain_proposals", 0) + plain[0] - p0
            acc["calls"] = acc.get("calls", 0) + 1
            return out
        return wrapped

    saved = [(cls, meth, getattr(cls, meth)) for cls, meth in inside]
    twins = [0]
    products = [0]
    real_product = hmc.NutsMove.product

    def product(self, w):
        products[0] += 1
        return real_product(self, w)

    def twin_counting(fn):
        def k(*a, **kw):
            twins[0] += 1
            return fn(*a, **kw)
        return k

    import importlib

    real_twins = [(mod, name, getattr(mod, name)) for mod, names in (
        (importlib.import_module(f"mcmcdate_tpu_torch.kernels.{m}"), n) for m, n in PLAIN_TWINS)
        for name in names]
    for kk, fn in real_k.items():
        P.KERNELS[kk] = counting(fn)
    for cls, meth, real in saved:
        setattr(cls, meth, inside_of(real, within.setdefault(meth, {})))
    for mod, name, fn in real_twins:
        setattr(mod, name, twin_counting(fn))
    hmc.NutsMove.product = product
    try:
        out = run()
    finally:
        hmc.NutsMove.product = real_product
        P.KERNELS.update(real_k)
        for cls, meth, real in saved:
            setattr(cls, meth, real)
        for mod, name, fn in real_twins:
            setattr(mod, name, fn)
    counts = {k: w.launches for k, w in wrappers.items()}
    counts.update({f"contra_range_{rb}": n for rb, n in by_rows.items()})
    counts.update({f"ticket_scan_{k}": n for k, n in by_kind.items()})
    counts["contra_range_bold"] = wrappers["contra_range"].launches_bold
    counts["glob_scan_bold"] = wrappers["glob_scan"].launches_bold
    counts["plain_proposals"] = plain[0]
    counts["plain_twins"] = twins[0]
    counts["nuts_product"] = products[0]
    return counts, out


def _de_recorded(run):
    """``run()`` with the fiber DE's half-updates recorded: returns ``(rec,
    run's result)``, ``rec["last"]`` the ``(act0, DEOut)`` of each
    half-update after the last chunk (``ChainRunner._de_rounds`` starts a
    new list), ``rec["accepts"]`` the accepts of all of them (a 0-dim
    tensor, or 0)."""
    from mcmcdate_tpu_torch.engine.chains import ChainRunner
    from mcmcdate_tpu_torch.engine.ensemble import FiberDE

    rec = {"last": [], "accepts": 0}
    real_half, real_rounds = FiberDE.half_update, ChainRunner._de_rounds

    def half_update(self, batch, act0, m, oth0, draws):
        out = real_half(self, batch, act0, m, oth0, draws)
        rec["last"].append((act0, out._replace(**{k: v.clone()
                                                  for k, v in out._asdict().items()})))
        rec["accepts"] = rec["accepts"] + out.accept.sum()
        return out

    def de_rounds(self, batch, seed):
        rec["last"] = []
        return real_rounds(self, batch, seed)

    FiberDE.half_update, ChainRunner._de_rounds = half_update, de_rounds
    try:
        out = run()
    finally:
        FiberDE.half_update, ChainRunner._de_rounds = real_half, real_rounds
    return rec, out


def _check_all_launched(name, launches, banded=False):
    """Every kernel of a CLI run at 136 taxa was launched: all but
    contra_range's buckets one by one, T3's heavy kernel (at 136 taxa no
    ticket's work passes HEAVY; the univariate 10k phase runs it), A1-A3
    (the 1000-taxon sparse prepare's), M1 (the MC3 paths') and the optional
    moves' F1, F2 and bold launches (the optional paths'); K2 ``whiten`` under a dense
    precision, B1 and B2 under the banded kind (and not K2)."""
    skip = ("plain_proposals", "plain_twins", "ticket_scan_heavy", "cascade_seed", *ADMM_NAMES,
            *NUTS_NAMES, "nuts_product", "mc3_swap", *OPT_NAMES,
            *(("whiten",) if banded else BAND_NAMES))
    for k, n in launches.items():
        if k not in skip:
            check(n > 0 or k.startswith("contra_range_"), f"the {name} never launched {k}")
    if banded:
        check(launches["whiten"] == 0, f"the {name} launched K2 on the banded kind")


def _check_seq_phase(name, within):
    """FastSweeps' sequential phase went through the ticket kernels alone:
    no K1, no plain proposal, T3 launched."""
    n = within.get("seq_phase", {})
    check(n.get("calls", 0) > 0, f"{name}: the sequential phase never ran")
    check(n["prior_terms"] == 0 and n["plain_proposals"] == 0 and n["ticket_scan"] > 0,
          f"{name}: the sequential phase launched {n}, not T3 (and T1, K2, K3) alone")
    return {k: round(v / n["calls"], 2) for k, v in n.items() if v and k != "calls"}


def _check_seq_sweeps(name, kern, within, n_chunks):
    """Every MHKernel sweep went through the ticket kernels alone: no K1
    and no plain proposal inside a sweep; T1, K2 and K3 once per ticket
    that breaks a run, T3 once per heavy ticket and at most once per run
    between them.  Returns the launches per sweep."""
    from mcmcdate_tpu_torch.kernels.ticket_step import HEAVY

    n = within.get("sweep_once", {})
    calls = n.get("calls", 0)
    check(calls > 0, f"{name}: no sweep ran")
    tt = kern.tt
    brk = sum(tt.breaks(int(p)) for p in kern.table.tickets)
    heavy = sum(not tt.breaks(int(p)) and tt.work[p] > HEAVY for p in kern.table.tickets)
    want = {"ticket_prologue": brk * calls, "accept_select": brk * calls,
            "band_matmul" if tt.banded else "whiten": brk * calls}
    got = {k: n.get(k, 0) for k in want}
    check(got == want, f"{name}: T1, K2 (B1 under the banded kind), K3 launched {got}, not "
          f"once per breaking ticket {want}")
    check(n["prior_terms"] == 0 and n["plain_proposals"] == 0,
          f"{name}: a sweep launched K1 or a plain proposal: {n}")
    check(max(1, heavy) * calls <= n["ticket_scan"] <= (2 * (brk + heavy) + n_chunks) * calls,
          f"{name}: {n['ticket_scan']} T3 launches in {calls} sweeps ({heavy} heavy tickets)")
    return {k: round(v / calls, 2) for k, v in n.items() if v and k != "calls"}


def _check_point_path(name, launches, kern):
    """The point and range phases of a FastSweeps run went through K4 and
    K5 alone: one prologue, scan and epilogue per likelihood point step and
    range block, or without a likelihood one prologue and epilogue and no
    scan (no plain step), and every contrary range bucket of the plan
    through K6."""
    from mcmcdate_tpu_torch.engine import proposals as P

    for step in ("point", "range"):
        names = tuple(f"{step}_{k}" for k in ("lik_prologue", "scan", "lik_epilogue"))
        n = {k: launches[k] for k in names}
        want = n[names[0]] > 0 and n[names[2]] == n[names[0]]
        want = want and n[names[1]] == (n[names[0]] if kern.use_lik else 0)
        check(want, f"{name}: the {step} steps launched {n}, not one prologue, "
              f"{'scan' if kern.use_lik else 'no scan'} and epilogue per step")
    for (k, rb) in kern.range_t:
        if k == P.K_SCALE_SUBTREES_CONTRA:
            check(launches[f"contra_range_{rb}"] > 0,
                  f"{name}: never launched contra_range on the {rb}-row bucket")


def phase_main_path():
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import cli
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        cli.main(["simulate", "--leaves", str(MAIN_TAXA), "--trees", str(TREES),
                  "--out", data])
        log(f"[main path] simulate took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli.main(["prepare", "-a", "smoke", "--rooted-tree", os.path.join(data, "time.tree"),
                  "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec", "full",
                  "--out-dir", tmp])
        log(f"[main path] prepare took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        within = {}
        launches, runner = _counted(lambda: cli.main(
            ["run", "-a", "smoke", "--chains", str(CHAINS), "--profile", "--seed", "1",
             "--device", "cuda", "--iterations", str(ITERATIONS), "--out-dir", tmp]),
            inside=((FastSweeps, "seq_phase"),), within=within)
        wall = time.perf_counter() - t0
        check(isinstance(runner.kern, FastSweeps), "run did not take FastSweeps")
        for suffix in ("params.monitor", "timetree.monitor", "ratetree.monitor",
                       "prior.monitor", "mcmc.npz", "mcmc.json", "trace.npz"):
            check(os.path.exists(os.path.join(tmp, f"smoke.{suffix}")), f"missing smoke.{suffix}")
        with np.load(os.path.join(tmp, "smoke.trace.npz")) as z:
            lp_post = z["lp_post"]
        check(lp_post.shape[1] == CHAINS, f"trace has {lp_post.shape[1]} chains")
        check(bool(np.isfinite(lp_post[-1]).all()), "lp_post is not finite for every chain")
        lp_err, lp_f64 = check_carried_posterior(runner, tmp, lp_post[-1])
        rate = runner.accepted / runner.attempted
        check(0.0 < rate < 1.0, f"overall acceptance {rate}")
        n_sweeps = len(runner.sweep_seconds) * 10
        _check_all_launched("main path", launches)
        check(launches["plain_proposals"] == 0, "the main path ran a plain proposal kernel")
        seq_per_sweep = _check_seq_phase("main path", within)
        _check_point_path("main path", launches, runner.kern)
        # The sequential model for the last phase: this run's prepared data,
        # which the marginal-likelihood phases read too (a copy that they
        # remove).
        args = cli.build_parser().parse_args(["run", "-a", "smoke", "--out-dir", tmp])
        seq_model, seq_init = cli._load_model(args, torch.device("cuda"), torch.float32,
                                              lambda *a: None)
        prep = tempfile.mkdtemp(prefix="smoke_prep_")
        for suffix in ("data", "meantree"):
            shutil.copy(os.path.join(tmp, f"smoke.{suffix}"), prep)
    med = statistics.median(runner.sweep_seconds)
    per_sweep = {k: n / n_sweeps for k, n in launches.items()}
    log(f"[main path] FastSweeps, {MAIN_TAXA} taxa x {CHAINS} chains, {n_sweeps} sweeps "
        f"(--profile burn-in of 60, then {ITERATIONS} iterations: cut from --profile's 50) "
        f"in {wall:.1f} s; median "
        f"{med:.4f} s per sweep on {torch.cuda.get_device_name(0)}; acceptance {rate:.4f}; "
        f"carried log posterior within {lp_err:.3g} of the direct float32 one (float32 vs "
        f"float64 evaluation of the final state: {lp_f64:.3g}); launches {launches}; "
        f"per sweep {json.dumps({k: round(v, 2) for k, v in per_sweep.items()})}; the "
        f"sequential phase per sweep, no K1 and no plain proposal: {json.dumps(seq_per_sweep)}")
    return launches, (seq_model, seq_init), prep


def _check_lp(name, model, batch, lp_carried):
    """A run's carried float32 log posterior against a direct float32
    evaluation of its final state, and that against float64 (the limits of
    the main path's check)."""
    import torch

    from mcmcdate_tpu_torch.tools.profile_sweep import direct_log_posterior

    d32 = direct_log_posterior(model, batch, torch.float32).double()
    d64 = direct_log_posterior(model, batch, torch.float64)
    check(bool(torch.isfinite(lp_carried).all()), f"{name}: log posterior not finite")
    scale = float(d32.abs().max())
    err = float((lp_carried.double() - d32).abs().max())
    check(err <= LP_REL * scale,
          f"{name}: carried log posterior off the direct one by {err:.3g} at scale {scale:.3g}")
    err64 = float((d32 - d64).abs().max())
    check(err64 <= LP_F64_REL * scale,
          f"{name}: float32 log posterior off float64 by {err64:.3g} at scale {scale:.3g}")
    return err, err64


def _runner_phase(name, model, init, fast_sweep, n_sweeps, need, stats=None):
    """``n_sweeps`` sweeps through ``ChainRunner`` (chunks of 10, counted),
    then one more sweep whose carried log posterior is checked.  Fails
    unless every kernel in ``need`` was launched, or where a sweep's
    sequential part (FastSweeps' sequential phase, or the sequential
    sweep) launched K1 or a plain proposal.  ``stats`` (a dict) receives
    the runner (``runner``), its construction's host seconds (``init_s``:
    the sweep's ``__init__``), the median seconds per sweep (``sweep_s``)
    and the device memory's peak over the phase (``peak_bytes``)."""
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings, new_key
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps
    from mcmcdate_tpu_torch.engine.mh import MHKernel

    torch.cuda.reset_peak_memory_stats()
    table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    settings = RunSettings(name, n_chains=CHAINS, seed=1, device="cuda",
                           fast_sweep=fast_sweep)
    t0 = time.perf_counter()
    runner = ChainRunner(model, table, settings, log=lambda *a: None)
    _sync()
    init_s = time.perf_counter() - t0
    batch, tuning = runner.init_chains(init)

    def run():
        out = runner._run_window(batch, tuning, new_key(1), n_sweeps)
        b, _, acc, tot, _ = out
        b2, lp_pr, lp_lik, *_ = runner.kern.sweeps(b, tuning, 7, 1)
        return b2, lp_pr + lp_lik, float(acc.sum()) / float(tot.sum())

    t0 = time.perf_counter()
    within = {}
    inside = (FastSweeps, "seq_phase") if fast_sweep else (MHKernel, "sweep_once")
    launches, (batch, lp, rate) = _counted(run, inside=(inside,), within=within)
    wall = time.perf_counter() - t0
    for k in need:
        check(launches[k] > 0, f"{name}: never launched {k}")
    check(launches["plain_proposals"] == 0, f"{name}: ran a plain proposal kernel")
    if fast_sweep:
        _check_point_path(name, launches, runner.kern)
        seq = _check_seq_phase(name, within)
    else:
        seq = _check_seq_sweeps(name, runner.kern, within, 1)
    err, err64 = _check_lp(name, model, batch, lp)
    med = statistics.median(runner.sweep_seconds)
    if stats is not None:
        stats.update(runner=runner, init_s=init_s, sweep_s=med,
                     peak_bytes=torch.cuda.max_memory_allocated(), batch=batch, tuning=tuning)
    if fast_sweep and runner.kern.use_lik:
        gathered = sum(sx[k].untyped_storage().nbytes() for steps in runner.kern.spec_t.values()
                       for sx in steps for k in ("Prow", "Pblk") if k in sx)
        log(f"[{name}] the point steps' Prow and Pblk, gathered once: {gathered / 1e9:.3f} GB")
    log(f"[{name}] {type(runner.kern).__name__}, {model.topo.n_leaves} taxa x {CHAINS} "
        f"chains (built in {init_s:.2f} s), {n_sweeps + 1} sweeps in {wall:.1f} s; median "
        f"{med:.4f} s per sweep "
        f"(chunks of 10) on {torch.cuda.get_device_name(0)}; acceptance {rate:.4f}; carried "
        f"log posterior within {err:.3g} of the direct float32 one (float32 vs float64: "
        f"{err64:.3g}); launches {launches}; {'the sequential phase' if fast_sweep else 'a sweep'}"
        f" per sweep, no K1 and no plain proposal: {json.dumps(seq)}")
    return launches


def phase_full_width():
    from mcmcdate_tpu_torch import synthetic

    model, batch = synthetic.build(BENCH_TAXA, 1, device="cuda")
    log(f"[full width] cut: {FULL_WIDTH_SWEEPS} sweeps (+1 for the carry check)")
    return _runner_phase("full width", model, batch, True, FULL_WIDTH_SWEEPS,
                         ("point_lik_prologue", "point_scan", "point_lik_epilogue",
                          "range_lik_prologue", "range_scan", "range_lik_epilogue",
                          "contra_slide", "contra_range", "glob_scan", "glob_dense_prologue",
                          "glob_dense_epilogue", "ticket_prologue", "accept_select",
                          "ticket_scan"))


def phase_prior_only():
    import dataclasses

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.ops import mvn

    model, batch = synthetic.build(MAIN_TAXA, 1, device="cuda")
    model = dataclasses.replace(model, likelihood=mvn.LikelihoodData.none())
    log(f"[prior only] cut: {PRIOR_ONLY_SWEEPS} sweeps (+1 for the carry check)")
    return _runner_phase("prior only", model, batch, True, PRIOR_ONLY_SWEEPS,
                         ("point_lik_prologue", "point_lik_epilogue", "range_lik_prologue",
                          "range_lik_epilogue", "contra_slide", "contra_range", "glob_scan",
                          "glob_dense_prologue", "glob_dense_epilogue", "ticket_scan"))


def phase_sequential(seq):
    model, init = seq
    log(f"[sequential] cut: {SEQUENTIAL_SWEEPS} sweeps (+1 for the carry check) of the "
        f"main path's model")
    return _runner_phase("sequential", model, init, False, SEQUENTIAL_SWEEPS,
                         ("prior_terms", "whiten", "ticket_prologue", "accept_select",
                          "ticket_scan", "ticket_scan_light"))


def phase_univariate_10k():
    """The sequential path at its own full width: ChainRunner with the
    default settings on a univariate model of UNI_TAXA taxa (D = 19,997 >
    UNIVARIATE_DENSE_MAX, so the runner takes MHKernel; nothing O(N^2):
    no Cholesky factor) x CHAINS chains.  T3 against its plain version on
    a 256-ticket run of every kind (the record at this shape); then
    UNI_SWEEPS timed sweeps and one whose carried log posterior is checked,
    every sweep through T3 alone (no K1, no plain proposal, no T1, K2 or
    K3: no ticket breaks a run under the univariate kind)."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings
    from mcmcdate_tpu_torch.engine.fast_sweep import UNIVARIATE_DENSE_MAX
    from mcmcdate_tpu_torch.engine.mh import MHKernel
    from mcmcdate_tpu_torch.kernels.ticket_step import CHUNK, DC_RANGE, HEAVY, ticket_scan, \
        ticket_scan_plain
    from mcmcdate_tpu_torch.tools.seq_time import univariate_model

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, init = univariate_model(UNI_TAXA, seed=0)
    check(model.chol_internal is None, "the univariate model built a Cholesky factor")
    check(model.likelihood.dim > UNIVARIATE_DENSE_MAX,
          f"D = {model.likelihood.dim} does not exceed {UNIVARIATE_DENSE_MAX}")
    table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    runner = ChainRunner(model, table, RunSettings("uni10k", n_chains=CHAINS, seed=1,
                                                   device="cuda"), log=lambda *a: None)
    tk = runner.kern
    check(isinstance(tk, MHKernel), f"the runner took {type(tk).__name__}, not MHKernel")
    batch, tuning = runner.init_chains(init)
    _sync()
    setup_s = time.perf_counter() - t0
    s = _perturbed(model, batch, 3)
    _, err = _k1_agree(f"prior_terms at {UNI_TAXA} taxa", model, s)
    k1 = _k1_record(err, model, s)
    del s
    log(f"[kernels] prior_terms at {UNI_TAXA} taxa x {CHAINS} chains (univariate): max error "
        f"{err:.3g}, device time per call (L2 flushed): kernel {k1['ms']:.4f} ms, plain "
        f"{k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")
    n_t = int(table.n_tickets)
    log(f"[univariate 10k] {UNI_TAXA} taxa x {CHAINS} chains, D = {model.likelihood.dim}, "
        f"{table.n_proposals} proposal rows, {n_t} tickets a sweep ({-(-n_t // CHUNK)} chunks); "
        f"setup {setup_s:.1f} s; cut: {UNI_SWEEPS} timed sweeps (+1 for the carry check)")
    gen = torch.Generator(device="cuda").manual_seed(10)
    carry = tk.init_carry(batch)
    tt = tk.tt
    tickets = np.asarray(table.tickets)
    rng = np.random.default_rng(10)
    heavy = tt.work[tickets] > HEAVY
    light = rng.choice(tickets[~heavy], 256).astype(np.int32)
    # Heavy tickets alone: a subtree above 1,024 distances (the table's
    # DC_FULL, its own rows here) and the joint birth-death scale (the whole
    # birth-death block).
    big = [int(p) for p in np.unique(tickets[heavy]) if table.kind[p] == P.K_SCALE_SUBTREE_ULTRA
           and int(tk.table.d_class[p]) == P.DC_FULL]
    bd = [int(p) for p in np.unique(tickets[heavy]) if table.kind[p] == P.K_SCALE_SCALAR
          and table.aux[p] == P.SC_BIRTH_DEATH]
    check(big and bd, "univariate 10k: no heavy DC_FULL subtree or birth-death scale ticket")
    check(int(tt.d_class[big[0]]) == DC_RANGE, "univariate 10k: the big subtree is not DC_RANGE")
    recs = {}
    for what, order in (("light", light), ("heavy", np.asarray([bd[0]], np.int32)),
                        ("heavy_subtree", np.asarray([big[0]], np.int32))):
        dr = tk.draws(order, tuning, gen)
        w = {}
        ties, n_acc, n_all = _ticket_scan_agree(f"ticket_scan {what} at {UNI_TAXA} taxa", tk,
                                                carry, tuning, dr, w)
        if what == "light":
            check(0 < n_acc < n_all, f"ticket_scan accepted {n_acc} of {n_all}: not a mixed case")
        c1, c2 = _mh_copy(carry), _mh_copy(carry)
        name = "ticket_run_kernel" if what == "light" else "ticket_scan_kernel"
        ms = _device_ms(lambda: ticket_scan(tt, c1, tuning, dr, 0, len(order)), only=name,
                        reps=5)
        plain_ms = _device_ms(lambda: ticket_scan_plain(tt, c2, tuning, dr, 0, len(order)),
                              reps=1)
        fl, nbd, ot = _ticket_work(tt, order)
        rec = _record(max(w.get("prop", 0.0), w.get("y", 0.0)), ms, plain_ms, 4 * CHAINS * fl,
                      CHAINS * (40 * ot + 100 * len(order)), ops64=100 * CHAINS * nbd)
        per = (f"{ms / len(order) * 1e3:.2f} us a ticket" if what == "light"
               else f"work {int(tt.work[order[0]])}")
        log(f"[kernels] ticket_scan at {UNI_TAXA} taxa x {CHAINS} chains (univariate, {what}: "
            f"{len(order)} ticket(s) of rows {sorted(set(order.tolist()))[:4]}...): {n_acc} "
            f"accepts of {n_all}, {ties} tie decisions differ from the replay, state, terms and d "
            f"bitwise equal to it; largest differences {json.dumps(w)}; device time per call "
            f"({name}): kernel {ms:.4f} ms ({per}), plain {plain_ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        recs[what] = rec
    del carry, c1, c2
    torch.cuda.empty_cache()
    rec = {k: recs[k] for k in ("light", "heavy")}

    def run():
        times, b = [], batch
        for i in range(UNI_SWEEPS):
            t1 = time.perf_counter()
            b = tk.sweeps(b, tuning, 2 + i, 1)[0]
            _sync()
            times.append(time.perf_counter() - t1)
        b2, lp_pr, lp_lik, acc, tot, _ = tk.sweeps(b, tuning, 7, 1)
        return times, b2, lp_pr + lp_lik, float(acc.sum()) / float(tot.sum())

    within = {}
    t0 = time.perf_counter()
    launches, (times, b2, lp, rate) = _counted(run, inside=((MHKernel, "sweep_once"),),
                                               within=within)
    wall = time.perf_counter() - t0
    check(launches["plain_proposals"] == 0, "univariate 10k: ran a plain proposal kernel")
    per_sweep = _check_seq_sweeps("univariate 10k", tk, within, -(-n_t // CHUNK))
    check(launches["ticket_scan_light"] > 0 and launches["ticket_scan_heavy"] > 0,
          f"univariate 10k: T3's light and heavy kernels launched "
          f"{launches['ticket_scan_light']} and {launches['ticket_scan_heavy']} times")
    check(0.0 < rate < 1.0, f"univariate 10k: acceptance {rate}")
    err, err64 = _check_lp("univariate 10k", model, b2, lp)
    log(f"[univariate 10k] MHKernel, {UNI_SWEEPS + 1} sweeps in {wall:.1f} s; sweeps "
        f"{json.dumps([round(t, 4) for t in times])} s, median {statistics.median(times):.4f} s "
        f"per sweep on {torch.cuda.get_device_name(0)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; acceptance {rate:.4f}; carried log "
        f"posterior within {err:.3g} of the direct float32 one (float32 vs float64: "
        f"{err64:.3g}); launches per sweep {json.dumps(per_sweep)}")
    return launches, rec, k1


def _check_ml_launches(name, launches, seeds):
    """A marginal-likelihood path went through the kernels: every decision
    kernel launched, ``seeds`` cascade_seed launches, no plain proposal and
    no plain twin."""
    for k in BETA_KERNELS:
        check(launches[k] > 0, f"{name}: never launched {k}")
    check(launches["cascade_seed"] == seeds,
          f"{name}: {launches['cascade_seed']} cascade_seed launches, not {seeds}")
    check(launches["plain_proposals"] == 0 and launches["plain_twins"] == 0,
          f"{name}: ran {launches['plain_proposals']} plain proposals and "
          f"{launches['plain_twins']} plain twins")


def phase_marginal_likelihood(prep):
    """The CLI's marginal-likelihood --profile (12 stones: the cascade of 11
    rungs x 3 sweeps, 60 + 100 burn-in sweeps, ML_ITERATIONS iterations) on
    the main path's prepared 136-taxon data: the log's cascade line and a
    finite log Z, the beta = 1 stone's mean log likelihood above the beta
    = 0 stone's, every decision kernel and 11 cascade_seed launches, no
    plain proposal, no plain twin, the sequential phase without K1."""
    import numpy as np

    from mcmcdate_tpu_torch import cli
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps
    from mcmcdate_tpu_torch.engine.stepping_stone import N_POINTS_PROF

    within = {}
    t0 = time.perf_counter()
    launches, res = _counted(lambda: cli.main(
        ["marginal-likelihood", "-a", "smoke", "--profile", "--seed", "1", "--device", "cuda",
         "--iterations", str(ML_ITERATIONS), "--out-dir", prep]),
        inside=((FastSweeps, "seq_phase"),), within=within)
    wall = time.perf_counter() - t0
    with open(os.path.join(prep, "smoke.mlh.log")) as fh:
        lines = fh.read().splitlines()
    casc = [s for s in lines if s.startswith("annealed-init cascade:")]
    check(len(casc) == 1 and f" {N_POINTS_PROF - 1} rungs x 3 sweeps" in casc[0],
          f"smoke.mlh.log has no cascade line of {N_POINTS_PROF - 1} rungs: {casc}")
    lz = [s for s in lines if s.startswith("log marginal likelihood")]
    check(len(lz) == 1 and math.isfinite(float(lz[0].rsplit(" ", 1)[1])),
          f"smoke.mlh.log has no finite log Z: {lz}")
    check(math.isfinite(res.log_marginal_likelihood), "log Z is not finite")
    ll = res.mean_log_lik_per_point
    check(bool(np.isfinite(ll).all()) and ll[-1] > ll[0],
          f"stone log likelihoods {ll[0]} (beta 0) and {ll[-1]} (beta 1)")
    _check_ml_launches("marginal likelihood", launches, N_POINTS_PROF - 1)
    seq = _check_seq_phase("marginal likelihood", within)
    sampling = [s for s in lines if s.startswith("sampling:")]
    log(f"[marginal likelihood] CLI --profile at {MAIN_TAXA} taxa, {N_POINTS_PROF} stones, "
        f"{ML_ITERATIONS} iterations (cut from --profile's 50) in {wall:.1f} s: {casc[0]}; "
        f"{sampling[0] if sampling else ''}; log Z {res.log_marginal_likelihood:.4f}; mean log "
        f"likelihood by stone {json.dumps([round(float(x), 3) for x in ll])}; launches "
        f"{launches}; the sequential phase per sweep: {json.dumps(seq)}")
    return launches


def phase_ml_full_ladder(seq):
    """``annealed_cascade`` over all N_POINTS stones (one chain a stone) on
    the main path's 136-taxon model, then two chunks of CHUNK sweeps with
    each stone's log likelihood collected and the estimator, then one sweep
    whose carried log posterior is checked: 127 cascade_seed launches,
    the middle rung's seeding bitwise the per-field copy's, every decision
    kernel launched, no plain proposal or twin, a finite log Z, the beta =
    1 stone above the beta = 0 stone.  Returns the launches and the
    cascade's and the chunks' times."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.chains import CHUNK, ChainRunner, RunSettings, new_key
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps
    from mcmcdate_tpu_torch.engine.stepping_stone import N_POINTS, annealed_cascade, \
        beta_ladder, stepping_stone_log_z
    from mcmcdate_tpu_torch.kernels.cascade_seed import cascade_seed_plain
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    model, init = seq
    table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    runner = ChainRunner(model, table, RunSettings("ml_full", n_chains=N_POINTS, seed=1,
                                                   device="cuda"), log=lambda *a: None)
    kern = runner.kern
    betas = torch.as_tensor(beta_ladder(N_POINTS), dtype=torch.float32, device="cuda")
    batch, tuning = runner.init_chains(init)
    J = N_POINTS // 2
    probe = {"rung": 0, "ref": None, "same": None}

    def sweeps_fn(b, tu, seed, n, beta=None):
        # Rung J's output, seeded by the kernel, against a copy seeded by the
        # plain version (taken before the kernel's launch on the stream).
        if probe["rung"] == J + 1:
            probe["same"] = all(torch.equal(getattr(b, f), getattr(probe["ref"], f))
                                for f in FIELDS)
        out = kern.sweeps(b, tu, seed, n, beta=beta)
        if probe["rung"] == J:
            probe["ref"] = State(**{f: getattr(out[0], f).clone() for f in FIELDS})
            cascade_seed_plain(probe["ref"], J)
        probe["rung"] += 1
        return out

    def run():
        t0 = time.perf_counter()
        b = annealed_cascade(sweeps_fn, batch, tuning, new_key(2), betas, N_POINTS,
                             ML_CASCADE_SWEEPS)
        _sync()
        t_casc = time.perf_counter() - t0
        lls, secs = [], []
        for c in range(2):
            t0 = time.perf_counter()
            out = kern.sweeps(b, tuning, 11 + c, CHUNK, beta=betas,
                              collect=lambda s, lp_pr, lp_lik: lp_lik)
            b = out[0]
            lls.append(torch.stack(out[5]).cpu().numpy())
            secs.append((time.perf_counter() - t0) / CHUNK)
        b2, lp_pr, lp_lik, *_ = kern.sweeps(b, tuning, 7, 1, beta=betas)
        return b2, lp_pr + lp_lik, np.concatenate(lls), t_casc, secs

    within = {}
    launches, (b2, lp, ll, t_casc, secs) = _counted(run, inside=((FastSweeps, "seq_phase"),),
                                                    within=within)
    check(probe["same"] is True, f"rung {J}: cascade_seed's seeding differs from the per-field "
          f"copy's")
    _check_ml_launches("ml full ladder", launches, N_POINTS - 1)
    _check_seq_phase("ml full ladder", within)
    err, err64 = _check_lp("ml full ladder", model, b2, lp)
    log_z = stepping_stone_log_z(ll, betas.cpu().numpy())
    mean_ll = ll.mean(axis=0)
    check(math.isfinite(log_z), f"ml full ladder: log Z {log_z}")
    check(mean_ll[-1] > mean_ll[0], f"ml full ladder: stone log likelihoods {mean_ll[0]} "
          f"(beta 0) and {mean_ll[-1]} (beta 1)")
    rung_s = t_casc / (N_POINTS - 1)
    log(f"[ml full ladder] {MAIN_TAXA} taxa x {N_POINTS} stones on "
        f"{torch.cuda.get_device_name(0)}: the cascade ({N_POINTS - 1} rungs x "
        f"{ML_CASCADE_SWEEPS} sweeps, a "
        f"carry rebuilt a rung) {t_casc:.1f} s, {rung_s:.4f} s a rung; then {2 * CHUNK} sweeps "
        f"at {json.dumps([round(x, 4) for x in secs])} s a sweep (chunks of {CHUNK}); log Z "
        f"{log_z:.4f} from {ll.shape[0]} iterations (a smoke value, not an estimate); carried "
        f"log posterior within {err:.3g} of the direct float32 one (float32 vs float64: "
        f"{err64:.3g}); launches {launches}")
    return launches, dict(cascade_s=t_casc, rung_s=rung_s, sweep_s=secs)


def _monitor_iterations(run_dir, an, name):
    with open(os.path.join(run_dir, f"{an}.{name}.monitor")) as fh:
        return [int(line.split("\t", 1)[0]) for line in fh.read().splitlines()[1:]]


def _data_tag(run_dir, an):
    with open(os.path.join(run_dir, f"{an}.data")) as fh:
        return json.load(fh)["tag"]


def phase_sparse_tutorial():
    """The reference tutorials' workflow at their 136-taxon shape through the
    CLI: simulate -> prepare SPARSE_SPEC (the host BCD: D = 269, at most
    GLASSO_HOST_MAX) -> run --profile --iterations ITERATIONS (FastSweeps on
    the dense sparse precision; the main path's carry check) -> continue
    --iterations CONTINUE_ITERATIONS (rows numbered after the checkpoint's
    iteration, the checkpoint advanced, carry check) -> analyze."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import cli, prepare
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps

    an = "sp136"
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        cli.main(["simulate", "--leaves", str(MAIN_TAXA), "--trees", str(TREES), "--out", data])
        t0 = time.perf_counter()
        res = cli.main(["prepare", "-a", an, "--rooted-tree", os.path.join(data, "time.tree"),
                        "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec",
                        SPARSE_SPEC, "--out-dir", tmp])
        prep_s = time.perf_counter() - t0
        D = res.data.dim
        check(_data_tag(tmp, an) == "SparseS", f"{an}.data is not tagged SparseS")
        check(D == 2 * MAIN_TAXA - 3 and D <= prepare.GLASSO_HOST_MAX,
              f"D = {D}: not the host BCD's shape")
        kept = len(res.data.precision_assoc) / D ** 2
        within = {}
        t0 = time.perf_counter()
        launches, runner = _counted(lambda: cli.main(
            ["run", "-a", an, "--chains", str(CHAINS), "--profile", "--seed", "1", "--device",
             "cuda", "--iterations", str(ITERATIONS), "--out-dir", tmp]),
            inside=((FastSweeps, "seq_phase"),), within=within)
        run_s = time.perf_counter() - t0
        check(isinstance(runner.kern, FastSweeps), "sparse run did not take FastSweeps")
        check(runner.model.likelihood.kind == "sparse", "the run's likelihood is not sparse")
        with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
            lp_post = z["lp_post"]
        check(lp_post.shape == (ITERATIONS, CHAINS), f"trace lp_post {lp_post.shape}")
        lp_err, lp_f64 = check_carried_posterior(runner, tmp, lp_post[-1], name=an)
        _check_all_launched("sparse tutorial run", launches)
        check(launches["plain_proposals"] == 0, "the sparse run ran a plain proposal kernel")
        _check_seq_phase("sparse tutorial run", within)
        _check_point_path("sparse tutorial run", launches, runner.kern)
        before = {m: _monitor_iterations(tmp, an, m)
                  for m in ("params", "timetree", "ratetree", "prior")}
        t0 = time.perf_counter()
        c_launches, c_runner = _counted(lambda: cli.main(
            ["continue", "-a", an, "--profile", "--seed", "2", "--device", "cuda",
             "--iterations", str(CONTINUE_ITERATIONS), "--out-dir", tmp]))
        cont_s = time.perf_counter() - t0
        end = ITERATIONS + CONTINUE_ITERATIONS
        with open(os.path.join(tmp, f"{an}.mcmc.json")) as fh:
            it = json.load(fh)["iteration"]
        check(it == end, f"continue left the checkpoint at iteration {it}, not {end}")
        for m, rows in before.items():
            got = _monitor_iterations(tmp, an, m)
            want = rows + list(range(ITERATIONS + 2, end + 1, 2))
            check(got == want, f"{an}.{m}.monitor rows after continue: {got[-6:]}")
        with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
            lp_post = z["lp_post"]
        check(lp_post.shape == (end, CHAINS), f"continued trace lp_post {lp_post.shape}")
        c_err, _ = check_carried_posterior(c_runner, tmp, lp_post[-1], name=an)
        check(c_launches["plain_proposals"] == 0, "continue ran a plain proposal kernel")
        _check_all_launched("sparse tutorial continue", c_launches)
        t0 = time.perf_counter()
        cli.main(["analyze", "-a", an, "--out-dir", tmp])
        an_s = time.perf_counter() - t0
        for suffix in ("params.thinned", "timetree.tree.mean", "timetree.tree.combined",
                       "timetree.ages.summary", "timetree.nexus", "timetree.densitree.nex",
                       "ratetree.tree.mean"):
            check(os.path.getsize(os.path.join(tmp, f"{an}.{suffix}")) > 0,
                  f"analyze wrote no {an}.{suffix}")
        with open(os.path.join(tmp, f"{an}.timetree.ages.summary")) as fh:
            n_rows = len(fh.read().splitlines()) - 1
        check(n_rows == runner.model.topo.n, f"ages.summary has {n_rows} nodes")
    log(f"[sparse tutorial] {MAIN_TAXA} taxa x {CHAINS} chains, {SPARSE_SPEC}: prepare (host "
        f"BCD, D = {D}, {kept:.4f} of the precision kept) {prep_s:.1f} s; run (FastSweeps, "
        f"--profile burn-in of 60, then {ITERATIONS} iterations) {run_s:.1f} s, median "
        f"{statistics.median(runner.sweep_seconds):.4f} s per sweep on "
        f"{torch.cuda.get_device_name(0)}, carried log posterior within {lp_err:.3g} of the "
        f"direct float32 one (float32 vs float64: {lp_f64:.3g}); continue ({CONTINUE_ITERATIONS}"
        f" iterations, monitors appended to iteration {end}) {cont_s:.1f} s, carry within "
        f"{c_err:.3g}; analyze {an_s:.1f} s")
    return {k: launches[k] + c_launches[k] for k in launches}


def _admm_check(S_np, rho, W_k, Theta_k, iterations):
    """A1-A3 at the 1000-taxon prepare's own S: the whole ADMM once more by
    the kernels (it must repeat the prepare's Theta bitwise: the sums' order
    is fixed) and once by the plain versions on the card (the same
    iterations and zero pattern, Theta and W within ADMM_THETA_TOL); each
    kernel against its plain version on the final iterate's next iteration;
    each kernel's flushed device time, its plain version's and its bound;
    eigh's and the product's device times.  Returns the A1-A3 records."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch.kernels import glasso_admm as K
    from mcmcdate_tpu_torch.utils import glasso

    S = torch.as_tensor(S_np, dtype=torch.float64, device="cuda")
    p = S.shape[0]

    def host(run):
        th = run.Z.cpu().numpy()
        th = 0.5 * (th + th.T)
        return th, np.linalg.inv(th)

    _sync()
    t0 = time.perf_counter()
    run_k = glasso.admm_solve(S, rho)
    _sync()
    wall_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_p = glasso.admm_solve(S, rho, ops=K.PLAIN)
    _sync()
    wall_p = time.perf_counter() - t0
    th_k, _ = host(run_k)
    check(run_k.iterations == iterations and np.array_equal(th_k, Theta_k),
          "the kernel ADMM did not repeat the prepare's run bitwise")
    th_p, w_p = host(run_p)
    check(run_p.iterations == iterations,
          f"plain-route ADMM took {run_p.iterations} iterations, the kernels {iterations}")
    check(np.array_equal(Theta_k == 0, th_p == 0), "the two ADMM routes' zero patterns differ")
    err_th = float(np.abs(Theta_k - th_p).max())
    err_w = float(np.abs(W_k - w_p).max())
    check(err_th <= ADMM_THETA_TOL and err_w <= ADMM_THETA_TOL,
          f"ADMM routes differ: Theta by {err_th:.3g}, W by {err_w:.3g}")

    # One more iteration from the final iterate, pass by pass.
    Z, t, fac = run_k.Z, run_k.t, run_k.fac
    Uk, Up = run_k.U.clone(), run_k.U.clone()
    A = K.admm_shift(Z, Uk, S, t, fac)
    check(torch.equal(A, K.admm_shift_plain(Z, Up, S, t, fac)) and torch.equal(Uk, Up),
          "admm_shift differs from its plain version")
    lam, Q = torch.linalg.eigh(A)
    Qs = K.admm_eig_scale(lam, Q, t)
    check(torch.equal(Qs, K.admm_eig_scale_plain(lam, Q, t)),
          "admm_eig_scale differs from its plain version")
    T = (Qs @ Q.mT).contiguous()
    Zk, Zp, U2k, U2p = Z.clone(), Z.clone(), Uk.clone(), Uk.clone()
    rs_k = K.admm_update(T, Zk, U2k, glasso.ALPHA, rho / t)
    rs_p = K.admm_update_plain(T, Zp, U2p, glasso.ALPHA, rho / t)
    check(torch.equal(Zk, Zp) and torch.equal(U2k, U2p),
          "admm_update's Z or U differs from its plain version")
    rs_err = float((rs_k - rs_p).abs().max())
    check(rs_err <= ADMM_SUM_REL * float(rs_p.abs().max()),
          f"admm_update's sums differ by {rs_err:.3g} from {rs_p.tolist()}")

    # Timings.  Each kernel moves 2-5 p x p matrices (64-160 MB at 1000 taxa,
    # beyond the 50 MB L2), so back to back every call reads its inputs from
    # device memory and writes back the previous call's dirty lines.  That
    # steady state, by CUDA events around 20 calls (the host enqueues a call
    # faster than the card runs it), is the record.  The profiler's
    # intervals for these kernels, back to back and flushed, are logged
    # beside: they have come out below the bytes bound (PERF.md).  eigh and
    # the product by both.
    mat = 8 * p * p
    Ut, Zt, Ut2 = Uk.clone(), Z.clone(), Uk.clone()
    calls = {
        "admm_shift": (lambda: K.admm_shift(Z, Ut, S, t, 1.0),
                       lambda: K.admm_shift_plain(Z, Ut2, S, t, 1.0),
                       "admm_shift_kernel", 5 * mat, 6 * p * p, 0.0),
        "admm_eig_scale": (lambda: K.admm_eig_scale(lam, Q, t),
                           lambda: K.admm_eig_scale_plain(lam, Q, t),
                           "admm_eig_scale_kernel", 2 * mat + 8 * p, 6 * p * p, 0.0),
        "admm_update": (lambda: K.admm_update(T, Zt, Ut, glasso.ALPHA, rho / t),
                        lambda: K.admm_update_plain(T, Zp, U2p, glasso.ALPHA, rho / t),
                        ("admm_update_kernel", "admm_reduce_kernel"), 5 * mat, 14 * p * p,
                        rs_err),
    }
    def event_ms(fn, reps=10):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _sync()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        _sync()
        return start.elapsed_time(end) / reps

    recs = {}
    for name, (kern, plain, kname, nbytes, ops64, err) in calls.items():
        ms = event_ms(kern, reps=20)
        plain_ms = _device_ms(plain, reps=5)
        recs[name] = _record(err, ms, plain_ms, nbytes, 0, None, ops64=ops64)
        recs[name]["ms_profiler"] = _device_ms(kern, only=kname)
        recs[name]["ms_flushed"] = _device_ms(kern, only=kname, flush=True)
    eigh_ms = _device_ms(lambda: torch.linalg.eigh(A), reps=5)
    eigh_ev = event_ms(lambda: torch.linalg.eigh(A), reps=5)
    prod_ms = _device_ms(lambda: Qs @ Q.mT, reps=5)
    prod_ev = event_ms(lambda: Qs @ Q.mT, reps=20)
    prod_bound = max(3 * mat / PEAK_BYTES, 2 * p ** 3 / PEAK_F64_TC) * 1e3
    log(f"[sparse full width] ADMM at p = {p} (rho {rho}): {iterations} iterations; kernels "
        f"{wall_k:.3f} s ({wall_k / iterations * 1e3:.2f} ms an iteration, host clock), plain "
        f"route {wall_p:.3f} s; Theta within {err_th:.3g} and W within {err_w:.3g} of the "
        f"plain route, {float((Theta_k == 0).mean()):.4f} of Theta zero; device time per call: "
        f"eigh {eigh_ms:.4f} ms (CUDA events {eigh_ev:.4f}), product {prod_ms:.4f} ms (CUDA "
        f"events {prod_ev:.4f}; bound {prod_bound:.4f} ms at 67 TFLOP/s float64 on the tensor "
        f"cores); " + "; ".join(
            f"{k} {r['ms']:.4f} ms back to back by CUDA events (profiler: {r['ms_profiler']:.4f} "
            f"back to back, {r['ms_flushed']:.4f} flushed), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})" for k, r in recs.items()))
    for r in recs.values():
        r.update(eigh_ms=eigh_ms, eigh_event_ms=eigh_ev, product_ms=prod_ms,
                 product_event_ms=prod_ev, product_bound_ms=prod_bound, iterations=iterations)
    return recs


def phase_sparse_full_width():
    """The GOE tutorial's scale: simulate -> prepare SPARSE_SPEC at 1000 taxa
    (D = 1,997 > GLASSO_HOST_MAX: the ADMM on the card through A1-A3, each
    launched once an iteration) -> run --profile --iterations
    FULL_WIDTH_SWEEPS at 1000 taxa x 1024 chains (FastSweeps; carry check).
    A1-A3 are also held to their plain versions on that prepare's own S
    (``_admm_check``).  Returns the launches and the A1-A3 records."""
    import numpy as np

    from mcmcdate_tpu_torch import cli, prepare
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps
    from mcmcdate_tpu_torch.utils import glasso

    an = "sp1000"
    seen = {}
    real = glasso.graphical_lasso_admm

    def spy(S, rho, **kw):
        out = real(S, rho, **kw)
        seen.update(S=S, rho=rho, out=out, iterations=kw["stats"]["iterations"])
        return out

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        cli.main(["simulate", "--leaves", str(BENCH_TAXA), "--trees", str(TREES), "--out", data])
        sim_s = time.perf_counter() - t0
        glasso.graphical_lasso_admm = spy
        try:
            t0 = time.perf_counter()
            p_launches, res = _counted(lambda: cli.main(
                ["prepare", "-a", an, "--rooted-tree", os.path.join(data, "time.tree"),
                 "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec", SPARSE_SPEC,
                 "--device", "cuda", "--out-dir", tmp]))
            prep_s = time.perf_counter() - t0
        finally:
            glasso.graphical_lasso_admm = real
        D = res.data.dim
        check(D == 2 * BENCH_TAXA - 3 and D > prepare.GLASSO_HOST_MAX and "S" in seen,
              f"D = {D}: the prepare did not take the ADMM")
        check(_data_tag(tmp, an) == "SparseS", f"{an}.data is not tagged SparseS")
        its = seen["iterations"]
        got = {k: p_launches[k] for k in ADMM_NAMES}
        check(its > 0 and got == {k: its for k in ADMM_NAMES},
              f"A1-A3 launched {got} in {its} ADMM iterations, not once an iteration each")
        kept = len(res.data.precision_assoc) / D ** 2
        W_k, Theta_k = seen["out"]
        recs = _admm_check(seen["S"], seen["rho"], W_k, Theta_k, its)
        within = {}
        t0 = time.perf_counter()
        r_launches, runner = _counted(lambda: cli.main(
            ["run", "-a", an, "--chains", str(CHAINS), "--profile", "--seed", "1", "--device",
             "cuda", "--iterations", str(FULL_WIDTH_SWEEPS), "--out-dir", tmp]),
            inside=((FastSweeps, "seq_phase"),), within=within)
        run_s = time.perf_counter() - t0
        check(isinstance(runner.kern, FastSweeps), "sparse 1000 run did not take FastSweeps")
        check(runner.model.likelihood.kind == "sparse", "the run's likelihood is not sparse")
        with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
            lp_post = z["lp_post"]
        check(lp_post.shape == (FULL_WIDTH_SWEEPS, CHAINS), f"trace lp_post {lp_post.shape}")
        lp_err, lp_f64 = check_carried_posterior(runner, tmp, lp_post[-1], name=an)
        for k in ("point_lik_prologue", "point_scan", "point_lik_epilogue",
                  "range_lik_prologue", "range_scan", "range_lik_epilogue", "contra_slide",
                  "contra_range", "glob_scan", "glob_dense_prologue", "glob_dense_epilogue",
                  "ticket_prologue", "accept_select", "ticket_scan"):
            check(r_launches[k] > 0, f"sparse full width: never launched {k}")
        check(r_launches["plain_proposals"] == 0, "sparse full width ran a plain proposal")
        _check_seq_phase("sparse full width", within)
        _check_point_path("sparse full width", r_launches, runner.kern)
    log(f"[sparse full width] {BENCH_TAXA} taxa x {CHAINS} chains, {SPARSE_SPEC}: simulate "
        f"{sim_s:.1f} s; prepare (ADMM on the card, D = {D}, {its} iterations, {kept:.4f} of "
        f"the precision kept) {prep_s:.1f} s; run (FastSweeps, --profile burn-in of 60, then "
        f"{FULL_WIDTH_SWEEPS} iterations) {run_s:.1f} s, median "
        f"{statistics.median(runner.sweep_seconds):.4f} s per sweep, carried log posterior "
        f"within {lp_err:.3g} of the direct float32 one (float32 vs float64: {lp_f64:.3g})")
    return {k: p_launches[k] + r_launches[k] for k in p_launches}, recs


def _dense_tensors(kern, D, C):
    """Shapes of the tensors reachable from a sweep (its model, plan steps,
    glob constants and sequential kernel) with ``D`` columns on other rows
    than a chain batch's: ``[D, D]`` precisions and ``[rows, D]`` gathers."""
    import torch

    seen, out, todo = set(), [], [kern]
    while todo:
        obj = todo.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            if obj.dim() >= 2 and obj.shape[-1] == D and obj.shape[-2] != C:
                out.append(tuple(obj.shape))
        elif isinstance(obj, dict):
            todo.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            todo.extend(obj)
        elif type(obj).__module__.startswith("mcmcdate_tpu_torch") and hasattr(obj, "__dict__"):
            todo.extend(vars(obj).values())
    return out


def _check_banded_path(name, launches, kern):
    """A banded path launched B1 (and, on FastSweeps, B2 and band_rows_add:
    at least one launch a point step or range block with a likelihood), no
    K2, no plain version, and its sweep holds no dense precision."""
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps

    fast = isinstance(kern, FastSweeps)
    for k in ("band_matmul",) + (("band_matmul_t", "band_rows_add") if fast else ()):
        check(launches[k] > 0, f"{name}: never launched {k}")
    if fast:
        steps = launches["point_lik_epilogue"] + launches["range_lik_epilogue"]
        check(launches["band_rows_add"] == steps,
              f"{name}: {launches['band_rows_add']} band_rows_add launches for {steps} point "
              f"steps and range blocks")
    check(launches["whiten"] == 0 and launches["plain_twins"] == 0
          and launches["plain_proposals"] == 0,
          f"{name}: launched K2, a plain version or a plain proposal: {launches}")
    D = kern.model.likelihood.dim
    dense = _dense_tensors(kern, D, CHAINS)
    check(not dense, f"{name}: the banded sweep holds [D, D] or [rows, D] tensors {dense}")


def phase_banded_tutorial():
    """The banded kind through the CLI at the main path's 136 taxa x 1024
    chains: simulate -> prepare BANDED_SPEC (the host's Cholesky banding
    estimator; the .data file tagged BandedS) -> run --profile --iterations
    ITERATIONS (FastSweeps; the main path's carry check) -> analyze; then
    SEQUENTIAL_SWEEPS + 1 sweeps of MHKernel on the prepared model
    (RunSettings(fast_sweep=False)): T1, B1, K3 per ticket that moves
    distances."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import cli
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps

    an = "bd136"
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        cli.main(["simulate", "--leaves", str(MAIN_TAXA), "--trees", str(TREES), "--out", data])
        t0 = time.perf_counter()
        res = cli.main(["prepare", "-a", an, "--rooted-tree", os.path.join(data, "time.tree"),
                        "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec",
                        BANDED_SPEC, "--out-dir", tmp])
        prep_s = time.perf_counter() - t0
        check(_data_tag(tmp, an) == "BandedS", f"{an}.data is not tagged BandedS")
        check(res.data.bandwidth == BANDWIDTH, f"bandwidth {res.data.bandwidth}")
        within = {}
        t0 = time.perf_counter()
        launches, runner = _counted(lambda: cli.main(
            ["run", "-a", an, "--chains", str(CHAINS), "--profile", "--seed", "1", "--device",
             "cuda", "--iterations", str(ITERATIONS), "--out-dir", tmp]),
            inside=((FastSweeps, "seq_phase"),), within=within)
        run_s = time.perf_counter() - t0
        check(isinstance(runner.kern, FastSweeps) and runner.kern.banded,
              "the banded run did not take FastSweeps' banded branch")
        with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
            lp_post = z["lp_post"]
        check(lp_post.shape == (ITERATIONS, CHAINS), f"trace lp_post {lp_post.shape}")
        lp_err, lp_f64 = check_carried_posterior(runner, tmp, lp_post[-1], name=an)
        _check_all_launched("banded tutorial run", launches, banded=True)
        _check_banded_path("banded tutorial run", launches, runner.kern)
        seq = _check_seq_phase("banded tutorial run", within)
        _check_point_path("banded tutorial run", launches, runner.kern)
        t0 = time.perf_counter()
        cli.main(["analyze", "-a", an, "--out-dir", tmp])
        an_s = time.perf_counter() - t0
        for suffix in ("params.thinned", "timetree.tree.mean", "timetree.ages.summary",
                       "ratetree.tree.mean"):
            check(os.path.getsize(os.path.join(tmp, f"{an}.{suffix}")) > 0,
                  f"analyze wrote no {an}.{suffix}")
        args = cli.build_parser().parse_args(["run", "-a", an, "--out-dir", tmp])
        seq_model, seq_init = cli._load_model(args, torch.device("cuda"), torch.float32,
                                              lambda *a: None)
    per_sweep = {k: round(launches[k] / (len(runner.sweep_seconds) * 10), 2) for k in BAND_NAMES}
    log(f"[banded tutorial] {MAIN_TAXA} taxa x {CHAINS} chains, {BANDED_SPEC} (D = "
        f"{res.data.dim}): prepare {prep_s:.1f} s; run (FastSweeps, --profile burn-in of 60, "
        f"then {ITERATIONS} iterations) {run_s:.1f} s, median "
        f"{statistics.median(runner.sweep_seconds):.4f} s per sweep on "
        f"{torch.cuda.get_device_name(0)}, carried log posterior within {lp_err:.3g} of the "
        f"direct float32 one (float32 vs float64: {lp_f64:.3g}); B1 and B2 per sweep "
        f"{json.dumps(per_sweep)}; the sequential phase per sweep {json.dumps(seq)}; analyze "
        f"{an_s:.1f} s")
    log(f"[banded sequential] cut: {SEQUENTIAL_SWEEPS} sweeps (+1 for the carry check) of the "
        f"tutorial's model")
    stats = {}
    s_launches = _runner_phase("banded sequential", seq_model, seq_init, False,
                               SEQUENTIAL_SWEEPS, ("band_matmul", "ticket_prologue",
                                                   "accept_select", "ticket_scan"), stats)
    _check_banded_path("banded sequential", s_launches, stats["runner"].kern)
    return {k: launches[k] + s_launches[k] for k in launches}


def phase_banded_full_width():
    """The banded kind at its full width: FastSweeps through ChainRunner on
    the synthetic banded model of BANDED_TAXA taxa x 1024 chains (BANDED_SPEC:
    D = 9,997, nb = 79 blocks of 128), FULL_WIDTH_SWEEPS + 1 sweeps with the
    carry check; logs the seconds per sweep, B1's, B2's and band_rows_add's
    launches per sweep, the sweep's construction time and the device
    memory's peak; then one more sweep under the profiler: the device time
    of B1, B2 and band_rows_add in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, batch, build_s = _banded_model(BANDED_TAXA)
    _BANDED.clear()
    log(f"[banded full width] cut: {FULL_WIDTH_SWEEPS} sweeps (+1 for the carry check); the "
        f"model built in {build_s:.1f} s")
    stats = {}
    launches = _runner_phase("banded full width", model, batch, True, FULL_WIDTH_SWEEPS,
                             ("point_lik_prologue", "point_scan", "point_lik_epilogue",
                              "range_lik_prologue", "range_scan", "range_lik_epilogue",
                              "contra_slide", "contra_range", "glob_scan",
                              "glob_dense_prologue", "glob_dense_epilogue", "ticket_scan"),
                             stats)
    kern = stats["runner"].kern
    _check_banded_path("banded full width", launches, kern)
    n = FULL_WIDTH_SWEEPS + 1
    # B1 and B2 are one template (band_kernel<..., TRANS>), and share the
    # reduction's second pass.
    kernels = {"band_matmul": ("band_kernel", ", false>"), "band_matmul_t": ("band_kernel",
                                                                             ", true>"),
               "band_reduce": ("band_reduce_kernel",), "band_rows_add": ("band_rows_kernel",)}
    dev = {k: [0, 0.0] for k in kernels}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kern.sweeps(stats["batch"], stats["tuning"], 9, 1)
        _sync()
    for e in prof.profiler.kineto_results.events():
        for k, tags in kernels.items():
            if e.device_type() == DeviceType.CUDA and all(t in e.name() for t in tags):
                dev[k][0] += 1
                dev[k][1] += e.duration_ns() / 1e6
    log(f"[banded full width] {BANDED_TAXA} taxa x {CHAINS} chains, D = "
        f"{model.likelihood.dim}: median {stats['sweep_s']:.4f} s per sweep; launches per sweep "
        + ", ".join(f"{k} {launches[k] / n:.2f}" for k in BAND_NAMES)
        + "; device time in one profiled sweep "
        + ", ".join(f"{k} {ms:.2f} ms in {c} kernels" for k, (c, ms) in dev.items())
        + f"; FastSweeps built (ChainRunner) in {stats['init_s']:.2f} s; device memory "
        f"peak {stats['peak_bytes'] / 1e9:.2f} GB; no [D, D] or [rows, D] tensor")
    return launches


def _check_nuts_launched(name, launches):
    """A NUTS path launched H1, H2 and H3 and the product (H1 and H2 once a
    leapfrog step each), no plain twin and no plain proposal."""
    for k in (*NUTS_NAMES, "nuts_product"):
        check(launches[k] > 0, f"{name}: never launched {k}")
    check(launches["nuts_leapfrog_prologue"] == launches["nuts_leapfrog_epilogue"],
          f"{name}: {launches['nuts_leapfrog_prologue']} H1 but "
          f"{launches['nuts_leapfrog_epilogue']} H2 launches")
    check(launches["plain_twins"] == 0 and launches["plain_proposals"] == 0,
          f"{name}: ran {launches['plain_twins']} plain twins and {launches['plain_proposals']} "
          f"plain proposals")


def _per(launches, n):
    """H1-H3's and the product's launches a sweep of ``n``."""
    return {k: round(launches[k] / n, 2) for k in (*NUTS_NAMES, "nuts_product")}


def _nuts_line(lines, prefix):
    """The log line starting with ``prefix``, exactly one."""
    found = [s for s in lines if s.startswith(prefix)]
    check(len(found) == 1, f"expected one log line '{prefix}...', found {found}")
    return found[0]


def phase_hamiltonian_tutorial():
    """``--hamiltonian`` through the CLI at MAIN_TAXA x CHAINS: simulate ->
    prepare full -> run --hamiltonian --profile --iterations HAM_ITERATIONS (the
    adaptation and acceptance lines, a finite eps, H1-H3 launched, no plain
    twin, the carry check) -> continue --iterations CONTINUE_ITERATIONS (NUTS
    on from the checkpoint, its eps restored) -> marginal-likelihood
    --hamiltonian --profile (a finite log Z); then 1 + 1 MHKernel sweeps
    with the move (the carry check)."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import cli
    from mcmcdate_tpu_torch.engine import checkpoint as ckpt
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings
    from mcmcdate_tpu_torch.engine.hmc import NutsInCycle
    from mcmcdate_tpu_torch.engine.proposals import build_proposal_table

    an = "ham"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        cli.main(["simulate", "--leaves", str(MAIN_TAXA), "--trees", str(TREES), "--out", data])
        cli.main(["prepare", "-a", an, "--rooted-tree", os.path.join(data, "time.tree"),
                  "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec", "full",
                  "--out-dir", tmp])
        t0 = time.perf_counter()
        launches, runner = _counted(lambda: cli.main(
            ["run", "-a", an, "--chains", str(CHAINS), "--profile", "--seed", "1", "--device",
             "cuda", "--iterations", str(HAM_ITERATIONS), "--hamiltonian", "--out-dir",
             tmp]))
        run_s = time.perf_counter() - t0
        check(runner.nuts is not None, "run --hamiltonian built no NUTS move")
        with open(os.path.join(tmp, f"{an}.run.log")) as fh:
            lines = fh.read().splitlines()
        adapt = _nuts_line(lines, "NUTS adaptation: eps")
        move = _nuts_line(lines, "NUTS in-cycle move: mean acceptance statistic")
        eps = runner.nuts.eps
        check(math.isfinite(eps) and eps > 0, f"adapted eps {eps}")
        _check_nuts_launched("hamiltonian run", launches)
        with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
            lp_post = z["lp_post"]
        lp_err, lp_f64 = check_carried_posterior(runner, tmp, lp_post[-1], name=an)
        with open(os.path.join(tmp, f"{an}.mcmc.json")) as fh:
            check(json.load(fh).get("hamiltonian") is True,
                  "the checkpoint's meta lacks hamiltonian")
        saved = ckpt.load_arrays(an, ("nuts_eps", "nuts_inv_mass"), in_dir=tmp)
        check(float(saved["nuts_eps"]) == eps, "the checkpoint's nuts_eps is not the run's")
        n_sweeps = len(runner.sweep_seconds) * 10
        log(f"[hamiltonian tutorial] run --hamiltonian --profile, {MAIN_TAXA} taxa x {CHAINS} "
            f"chains, {n_sweeps} sweeps ({HAM_ITERATIONS} iterations) in {run_s:.1f} s, median "
            f"{statistics.median(runner.sweep_seconds):.4f} s per sweep on "
            f"{torch.cuda.get_device_name(0)}; {adapt}; {move}; carried log posterior within "
            f"{lp_err:.3g} of the direct float32 one (float32 vs float64: {lp_f64:.3g}); "
            f"H1-H3 and the product per sweep "
            f"{json.dumps(_per(launches, n_sweeps))}")
        out["run"] = launches

        t0 = time.perf_counter()
        c_launches, runner2 = _counted(lambda: cli.main(
            ["continue", "-a", an, "--profile", "--seed", "2", "--device", "cuda",
             "--iterations", str(CONTINUE_ITERATIONS), "--out-dir", tmp]))
        cont_s = time.perf_counter() - t0
        check(runner2.nuts is not None and runner2.nuts.eps == eps,
              "continue did not resume the NUTS move with the saved eps")
        _check_nuts_launched("hamiltonian continue", c_launches)
        with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
            lp_post = z["lp_post"]
        check(lp_post.shape[0] == HAM_ITERATIONS + CONTINUE_ITERATIONS,
              f"continued trace of {lp_post.shape[0]} draws")
        c_err, _ = check_carried_posterior(runner2, tmp, lp_post[-1], name=an)
        log(f"[hamiltonian tutorial] continue --iterations {CONTINUE_ITERATIONS} in {cont_s:.1f} "
            f"s with the NUTS move (eps {runner2.nuts.eps:.5f} from the checkpoint); carried log "
            f"posterior within {c_err:.3g}")
        out["continue"] = c_launches

        t0 = time.perf_counter()
        m_launches, res = _counted(lambda: cli.main(
            ["marginal-likelihood", "-a", an, "--profile", "--hamiltonian", "--seed", "1",
             "--device", "cuda", "--iterations", str(HAM_ITERATIONS), "--out-dir", tmp]))
        ml_s = time.perf_counter() - t0
        check(math.isfinite(res.log_marginal_likelihood), "log Z with NUTS is not finite")
        with open(os.path.join(tmp, f"{an}.mlh.log")) as fh:
            ml_adapt = _nuts_line(fh.read().splitlines(), "NUTS adaptation: eps")
        _check_nuts_launched("hamiltonian marginal likelihood", m_launches)
        log(f"[hamiltonian tutorial] marginal-likelihood --hamiltonian --profile in {ml_s:.1f} s: "
            f"log Z {res.log_marginal_likelihood:.4f}; {ml_adapt}; H1-H3 and the product "
            f"{json.dumps({k: m_launches[k] for k in (*NUTS_NAMES, 'nuts_product')})}")
        out["ml"] = m_launches

        args = cli.build_parser().parse_args(["run", "-a", an, "--out-dir", tmp])
        model, init = cli._load_model(args, torch.device("cuda"), torch.float32,
                                      lambda *a: None)
    table = build_proposal_table(model.topo, model.braces, model.calibrations_available)
    seq = ChainRunner(model, table, RunSettings("hamseq", n_chains=CHAINS, seed=1,
                                                device="cuda", fast_sweep=False),
                      log=lambda *a: None)
    nuts = NutsInCycle(model)
    nuts.eps, nuts.inv_mass = runner2.nuts.eps, runner2.nuts.inv_mass
    batch, tuning = seq.init_chains(init)

    def two():
        b = seq.kern.sweeps(batch, tuning, 3, 1, nuts=nuts)[0]
        return seq.kern.sweeps(b, tuning, 4, 1, nuts=nuts)

    s_launches, res2 = _counted(two)
    _check_nuts_launched("hamiltonian sequential", s_launches)
    err, err64 = _check_lp("hamiltonian sequential", model, res2[0], res2[1] + res2[2])
    log(f"[hamiltonian sequential] 1 + 1 MHKernel sweeps with the NUTS move at {MAIN_TAXA} "
        f"taxa x {CHAINS} chains: mean acceptance statistic {float(res2[6].mean()):.3f}; carried "
        f"log posterior within {err:.3g} (float32 vs float64: {err64:.3g}); launches "
        f"{json.dumps({k: s_launches[k] for k in (*NUTS_NAMES, 'nuts_product')})}")
    out["sequential"] = s_launches
    return {k: sum(p[k] for p in out.values()) for k in out["run"]}


def phase_hamiltonian_full_width():
    """The NUTS move at its full width: FastSweeps through ChainRunner on
    the synthetic model of BENCH_TAXA taxa x CHAINS chains (D = 1,997, dim =
    3,000): HAM_WARM_SWEEPS sweeps without the move, HAM_WINDOWS adaptation
    windows of HAM_FULL_SWEEPS sweeps with it (dual averaging from eps
    HAM_EPS0, the inverse mass from the chains' variances), then
    HAM_FULL_SWEEPS + 1 sweeps with the adapted eps (counted; the last with
    the carry check) and HAM_FULL_SWEEPS without the move, timed.  Logs
    s/sweep with and without, H1-H3's launches a sweep, the mean leapfrog
    steps a trajectory, the device memory's peak."""
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import hmc, proposals as P
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings, new_key

    model, init = synthetic.build(BENCH_TAXA, 1, device="cuda")
    table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)
    runner = ChainRunner(model, table, RunSettings("hamfull", n_chains=CHAINS, seed=1,
                                                   device="cuda"), log=lambda *a: None)
    runner.nuts = hmc.NutsInCycle(model)
    runner.nuts.eps = HAM_EPS0
    runner.nuts.da = hmc.DualAveraging.init(HAM_EPS0)
    batch, tuning = runner.init_chains(init)
    steps = []
    real = hmc.NutsMove.trajectory

    def counting(self, *a, **kw):
        q, astat, n = real(self, *a, **kw)
        steps.append(float(n.float().mean()))
        return q, astat, n

    hmc.NutsMove.trajectory = counting
    try:
        t0 = time.perf_counter()
        batch, key, _, _, _ = runner._run_window(batch, tuning, new_key(1), HAM_WARM_SWEEPS,
                                                 use_nuts=False)
        windows = []
        for _ in range(HAM_WINDOWS):
            batch, key, _, _, _ = runner._run_window(batch, tuning, key, HAM_FULL_SWEEPS)
            windows.append((round(runner.nuts.eps, 6),
                            round(statistics.mean(runner._nuts_astats), 3),
                            round(statistics.mean(steps), 2)))
            runner.adapt_nuts(batch)
            steps.clear()
        runner.finalize_nuts()
        adapt_s = time.perf_counter() - t0
        eps = runner.nuts.eps
        check(math.isfinite(eps) and eps > 0, f"adapted eps {eps}")
        runner.sweep_seconds.clear()
        torch.cuda.reset_peak_memory_stats()

        def run():
            b, k, _, _, _ = runner._run_window(batch, tuning, key, HAM_FULL_SWEEPS)
            out = runner.kern.sweeps(b, tuning, 7, 1, nuts=runner.nuts)
            return out, k

        launches, (out, key) = _counted(run)
        with_s = statistics.median(runner.sweep_seconds)
        peak = torch.cuda.max_memory_allocated()
        n_traj = len(steps)
        mean_steps = statistics.mean(steps)
    finally:
        hmc.NutsMove.trajectory = real
    _check_nuts_launched("hamiltonian full width", launches)
    err, err64 = _check_lp("hamiltonian full width", model, out[0], out[1] + out[2])
    runner.sweep_seconds.clear()
    runner._run_window(out[0], tuning, key, HAM_FULL_SWEEPS, use_nuts=False)
    without_s = statistics.median(runner.sweep_seconds)
    n = HAM_FULL_SWEEPS + 1
    log(f"[hamiltonian full width] {BENCH_TAXA} taxa x {CHAINS} chains, D = "
        f"{model.likelihood.dim}, dim = {runner.nuts.coords.dim}: {HAM_WARM_SWEEPS} sweeps "
        f"without the move, then {HAM_WINDOWS} adaptation windows of {HAM_FULL_SWEEPS} "
        f"sweeps (eps, mean acceptance statistic, mean steps: {windows}) in {adapt_s:.1f} s; "
        f"adapted eps {eps:.5f}; median {with_s:.4f} s per sweep with the move, "
        f"{without_s:.4f} s without, on {torch.cuda.get_device_name(0)}; {n_traj} "
        f"trajectories, mean {mean_steps:.2f} leapfrog steps a trajectory; mean acceptance "
        f"statistic {float(out[6].mean()):.3f}; per sweep {json.dumps(_per(launches, n))}; "
        f"carried log posterior within {err:.3g} (float32 vs float64: {err64:.3g}); device "
        f"memory peak {peak / 1e9:.2f} GB")
    return launches

def _mc3_checked(name, run_dir, an, runner, launches, sweeps, hamiltonian):
    """The outputs and launches of an MC3 run or continue of ``sweeps``
    sweeps through the CLI: the JAX package's log lines, the MC3 meta with
    the ladder's ``mc3_dt``, a finite cold-chain trace of MC3_GROUPS
    columns, the diagnostics file, one M1 launch a chunk of two sweeps,
    every kernel of the main path, and no plain twin or plain proposal;
    the NUTS kernels launched exactly when ``hamiltonian``.  Returns the
    log's swap line."""
    import numpy as np

    from mcmcdate_tpu_torch.engine import checkpoint as ckpt
    from mcmcdate_tpu_torch.engine.mc3 import N_TEMPS, SWAP_PERIOD

    mode = "continue" if "continue" in name else "run"
    with open(os.path.join(run_dir, f"{an}.{mode}.log")) as fh:
        lines = fh.read().splitlines()
    _nuts_line(lines, f"MC3: {MC3_GROUPS} groups x {N_TEMPS} temperatures")
    swaps = _nuts_line(lines, "sampling done; swap acceptance rate")
    check("(per temperature pair: 0<->1: " in swaps, f"{name}: {swaps}")
    if mode == "run":
        windows = [x for x in lines if x.startswith("burn-in [")]
        check(windows and all(", dt [" in x for x in windows), f"{name}: burn-in lines {windows}")
    with open(os.path.join(run_dir, f"{an}.mcmc.json")) as fh:
        meta = json.load(fh)
    check(meta.get("mc3") is True and meta.get("n_groups") == MC3_GROUPS
          and meta.get("n_temps") == N_TEMPS and bool(meta.get("hamiltonian")) == hamiltonian,
          f"{name}: meta {meta}")
    dt = ckpt.load_arrays(an, ("mc3_dt",), in_dir=run_dir)["mc3_dt"]
    check(dt.shape == (N_TEMPS - 1,) and np.array_equal(dt, runner.mc3["dt"]),
          f"{name}: mc3_dt {dt} is not the run's {runner.mc3['dt']}")
    with np.load(os.path.join(run_dir, f"{an}.trace.npz")) as z:
        lp_post = z["lp_post"]
    check(lp_post.shape[1] == MC3_GROUPS and bool(np.isfinite(lp_post).all()),
          f"{name}: cold-chain trace of shape {lp_post.shape} (finite: "
          f"{bool(np.isfinite(lp_post).all())})")
    check(os.path.exists(os.path.join(run_dir, f"{an}.diagnostics.tsv")),
          f"{name}: no diagnostics file")
    check(launches["mc3_swap"] == sweeps // SWAP_PERIOD,
          f"{name}: {launches['mc3_swap']} M1 launches in {sweeps} sweeps")
    _check_all_launched(name, launches)
    check(launches["plain_twins"] == 0 and launches["plain_proposals"] == 0,
          f"{name}: ran {launches['plain_twins']} plain twins and "
          f"{launches['plain_proposals']} plain proposals")
    if hamiltonian:
        _check_nuts_launched(name, launches)
    else:
        check(all(launches[k] == 0 for k in (*NUTS_NAMES, "nuts_product")),
              f"{name}: launched a NUTS kernel without --hamiltonian")
    return swaps


def phase_mc3_tutorial():
    """``--mc3`` through the CLI at MAIN_TAXA x CHAINS (MC3_GROUPS groups of 4
    temperatures): simulate -> prepare full -> run --mc3 --profile
    --iterations ITERATIONS -> continue --iterations CONTINUE_ITERATIONS (as
    MC3, from the saved ladder), then the same run and continue with
    --hamiltonian (NUTS resumed with its saved step size); each checked by
    ``_mc3_checked``."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import cli
    from mcmcdate_tpu_torch.engine.mc3 import DELTA_T

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        cli.main(["simulate", "--leaves", str(MAIN_TAXA), "--trees", str(TREES), "--out", data])
        cli.main(["prepare", "-a", "mc3", "--rooted-tree", os.path.join(data, "time.tree"),
                  "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec", "full",
                  "--out-dir", tmp])
        for ham in (False, True):
            an = "mc3h" if ham else "mc3"
            flag = ["--hamiltonian"] if ham else []
            t0 = time.perf_counter()
            launches, runner = _counted(lambda: cli.main(
                ["run", "-a", an, "--preparation-name", "mc3", "--chains", str(MC3_GROUPS),
                 "--mc3", "--profile", "--seed", "1", "--device", "cuda", "--iterations",
                 str(ITERATIONS), "--out-dir", tmp, *flag]))
            run_s = time.perf_counter() - t0
            name = f"mc3 tutorial{' --hamiltonian' if ham else ''}"
            check(runner.s.n_chains == CHAINS and (runner.nuts is not None) == ham,
                  f"{name}: {runner.s.n_chains} chains, NUTS {runner.nuts is not None}")
            sweeps = 60 + ITERATIONS
            swaps = _mc3_checked(name + " run", tmp, an, runner, launches, sweeps, ham)
            dt0 = runner.mc3["dt"]
            check(not np.allclose(runner.mc3["dt_history"][0], DELTA_T),
                  f"{name}: dt did not move in burn-in: {runner.mc3['dt_history']}")
            if ham:
                eps = runner.nuts.eps
                check(math.isfinite(eps) and eps > 0, f"{name}: adapted eps {eps}")
            log(f"[mc3 tutorial] run --mc3{' --hamiltonian' if ham else ''} --profile, "
                f"{MAIN_TAXA} taxa x {MC3_GROUPS} groups x 4 temperatures, {sweeps} sweeps in "
                f"{run_s:.1f} s, median {statistics.median(runner.sweep_seconds):.4f} s per sweep "
                f"(a chunk of 2 and its swap) on {torch.cuda.get_device_name(0)}; dt "
                f"{[round(float(x), 4) for x in dt0]}; {swaps}"
                + (f"; NUTS eps {runner.nuts.eps:.5f}" if ham else ""))
            out[f"run{int(ham)}"] = launches
            t0 = time.perf_counter()
            c_launches, runner2 = _counted(lambda: cli.main(
                ["continue", "-a", an, "--preparation-name", "mc3", "--profile", "--seed", "2",
                 "--device", "cuda", "--iterations", str(CONTINUE_ITERATIONS), "--out-dir",
                 tmp]))
            cont_s = time.perf_counter() - t0
            swaps = _mc3_checked(name + " continue", tmp, an, runner2, c_launches,
                                 CONTINUE_ITERATIONS, ham)
            check(runner2.mc3["dt"].tolist() == dt0.tolist(),
                  f"{name}: continue changed the ladder")
            if ham:
                check(runner2.nuts.eps == eps, f"{name}: continue did not resume the saved eps")
            with open(os.path.join(tmp, f"{an}.mcmc.json")) as fh:
                it = json.load(fh)["iteration"]
            check(it == ITERATIONS + CONTINUE_ITERATIONS, f"{name}: continued to iteration {it}")
            with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
                n_draws = z["lp_post"].shape[0]
            check(n_draws == ITERATIONS + CONTINUE_ITERATIONS,
                  f"{name}: continued trace of {n_draws} draws")
            log(f"[mc3 tutorial] continue --iterations {CONTINUE_ITERATIONS} in {cont_s:.1f} s "
                f"as MC3 from the saved ladder; {swaps}")
            out[f"continue{int(ham)}"] = c_launches
    return {k: sum(p[k] for p in out.values()) for k in out["run0"]}


def phase_mc3_full_width():
    """MC3 at its full width: ``run_mc3`` on the synthetic model of
    BENCH_TAXA taxa x CHAINS chains (MC3_GROUPS groups x 4 temperatures; D
    = 1,997): MC3_WINDOWS burn-in windows of MC3_WINDOW iterations, then
    MC3_ITERATIONS timed iterations and a continue of CONTINUE_ITERATIONS
    from the checkpoint; then the same with the NUTS move (the last
    MC3_HAM_WINDOWS windows slow).  Checks: the
    carried U the last swap read against a fresh evaluation of the state it
    read it from (_check_lp's limits), every pair's swap rate in (0, 1) on
    the counts pooled over the four runs, dt moved in burn-in, one M1
    launch a chunk; and one sweep of the
    untempered FastSweeps with beta_prior None and with a ones vector,
    bitwise equal.  Logs s/sweep (two sweeps and a swap a chunk, host
    clock) beside the plain sweep's."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import checkpoint as ckpt, mc3 as M
    from mcmcdate_tpu_torch.engine.chains import RunSettings
    from mcmcdate_tpu_torch.engine.mh import BurnInSettings
    from mcmcdate_tpu_torch.models.state import FIELDS, State

    model, init = synthetic.build(BENCH_TAXA, 1, device="cuda")
    seen = []
    real = M.mc3_swap

    def spy(batch, U, pair, u, betas):
        seen[:] = [State(**{f: getattr(batch, f).clone() for f in FIELDS}), U.clone()]
        return real(batch, U, pair, u, betas)

    M.mc3_swap = spy
    out, counts = {}, []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for ham in (False, True):
                n_slow = MC3_HAM_WINDOWS if ham else 0
                burn = BurnInSettings([MC3_WINDOW] * (MC3_WINDOWS - n_slow),
                                      [MC3_WINDOW] * n_slow)
                an = "mc3fullh" if ham else "mc3full"
                settings = RunSettings(an, burn_in=burn, iterations=MC3_ITERATIONS,
                                       n_chains=MC3_GROUPS, out_dir=tmp, seed=1, device="cuda")
                name = f"mc3 full width{' with NUTS' if ham else ''}"
                t0 = time.perf_counter()
                launches, runner = _counted(lambda: M.run_mc3(model, init, settings,
                                                              hamiltonian=ham,
                                                              log=lambda *a: None))
                wall = time.perf_counter() - t0
                n_sweeps = burn.total + MC3_ITERATIONS
                check(launches["mc3_swap"] == n_sweeps // M.SWAP_PERIOD,
                      f"{name}: {launches['mc3_swap']} M1 launches in {n_sweeps} sweeps")
                check(launches["plain_twins"] == 0 and launches["plain_proposals"] == 0,
                      f"{name}: a plain twin or proposal ran")
                check((launches["nuts_leapfrog_prologue"] > 0) == ham,
                      f"{name}: {launches['nuts_leapfrog_prologue']} H1 launches")
                b, U = seen
                err, err64 = _check_lp(f"{name} (the last swap's U)", model, b, U)
                Ug = U.double().view(MC3_GROUPS, -1)
                slots = (Ug - Ug[:, :1]).mean(0).tolist(), Ug.std(0).tolist()
                rates = runner.mc3["pair_rates"]
                counts.append(runner.mc3["pair_counts"])
                hist = runner.mc3["dt_history"]
                check(hist and not np.allclose(hist[0], M.DELTA_T),
                      f"{name}: dt did not move in burn-in: {hist}")
                sample_s = runner.sweep_seconds[-(MC3_ITERATIONS // M.SWAP_PERIOD):]
                med = statistics.median(sample_s)
                log(f"[{name}] {BENCH_TAXA} taxa x {MC3_GROUPS} groups x 4 temperatures "
                    f"(D = {model.likelihood.dim}), {n_sweeps} sweeps in {wall:.1f} s; "
                    f"sampling median {med:.4f} s per sweep (a chunk of 2 sweeps and its swap, "
                    f"host clock) on {torch.cuda.get_device_name(0)}; dt after each window "
                    f"{[[round(float(x), 4) for x in h] for h in hist]}; swap rates per pair "
                    f"{[round(float(x), 4) for x in rates]}, sampling "
                    f"{[round(float(x), 4) for x in runner.mc3['sampling_pair_rates']]}; the "
                    f"last swap's carried U within {err:.3g} of the direct float32 log "
                    f"posterior (float32 vs float64: {err64:.3g}); at that swap each slot's "
                    f"U less slot 0's, mean over the groups "
                    f"{[round(x, 1) for x in slots[0]]}, spread {[round(x, 1) for x in slots[1]]}"
                    + (f"; NUTS eps {runner.nuts.eps:.5f}" if ham else ""))
                out[f"run{int(ham)}"] = launches
                state, tuning, key, meta = ckpt.load(an, in_dir=tmp, device="cuda")
                t0 = time.perf_counter()
                c_launches, runner2 = _counted(lambda: M.run_mc3(
                    model, init, dataclasses.replace(settings, iterations=CONTINUE_ITERATIONS),
                    hamiltonian=ham, continue_from=(state, tuning, key, meta["iteration"]),
                    log=lambda *a: None))
                check(c_launches["mc3_swap"] == CONTINUE_ITERATIONS // M.SWAP_PERIOD
                      and runner2.mc3["dt"].tolist() == runner.mc3["dt"].tolist(),
                      f"{name}: continue launched {c_launches['mc3_swap']} M1 or moved dt")
                counts.append(runner2.mc3["pair_counts"])
                log(f"[{name}] continue of {CONTINUE_ITERATIONS} iterations from the "
                    f"checkpoint in {time.perf_counter() - t0:.1f} s; swap rates per pair "
                    f"{[round(float(x), 4) for x in runner2.mc3['pair_rates']]}")
                out[f"continue{int(ham)}"] = c_launches
            acc = sum(c[0] for c in counts)
            tot = sum(c[1] for c in counts)
            check(bool(((acc > 0) & (acc < tot)).all()),
                  f"mc3 full width: pooled swaps per pair {acc.tolist()} of {tot.tolist()}")
            log(f"[mc3 full width] swaps per pair pooled over the four runs: {acc.tolist()} of "
                f"{tot.tolist()}")
            # beta_prior None is a ones vector, bitwise.
            fs = runner.kern
            digests = []
            for bp in (None, torch.ones(CHAINS, device="cuda")):
                b2 = fs.sweeps(state, tuning, 11, 1, beta_prior=bp)[0]
                h = hashlib.sha256()
                for f in FIELDS:
                    h.update(getattr(b2, f).cpu().numpy().tobytes())
                digests.append(h.hexdigest()[:16])
            check(digests[0] == digests[1],
                  f"mc3 full width: a sweep with beta_prior None and with ones differ: {digests}")
            log(f"[mc3 full width] one untempered sweep with beta_prior None and with a ones "
                f"vector: state digests {digests[0]} and {digests[1]}")
    finally:
        M.mc3_swap = real
    return {k: sum(p[k] for p in out.values()) for k in out["run0"]}


def _opt_checked(name, launches, runner, sweeps, slide=True, de=True, bold=True, chunks=None):
    """An optional-moves run of ``sweeps`` sweeps: F1 once a colour class a
    sweep when ``slide`` (every sweep at --fiber-slide 1), F2 twice a round
    (two rounds a chunk) when ``de`` and never otherwise, K6's range blocks
    and G1's sub_contra family with the bold uniforms when ``bold`` (every
    contrary range launch and one G1 launch a sweep), every kernel of the
    main path, no plain twin or plain proposal.  ``chunks``: the chunks
    the rounds ran after (default: a chunk a 10 sweeps).  Returns the
    launches a sweep of F1, F2 and the bold paths."""
    from mcmcdate_tpu_torch.engine import proposals as P

    kern = runner.kern
    n_classes = len(kern.fiber_classes)
    want_f1 = n_classes * sweeps if slide else 0
    check(launches["fiber_slide"] == want_f1,
          f"{name}: {launches['fiber_slide']} F1 launches, {want_f1} expected")
    chunks = -(-sweeps // 10) if chunks is None else chunks
    want_f2 = 2 * int(round(FIBER_DE)) * chunks if de else 0
    check(launches["fiber_de"] == want_f2,
          f"{name}: {launches['fiber_de']} F2 launches, {want_f2} expected")
    has_sub = "sub_contra" in kern.glob_fam
    contra_blocks = any(k == P.K_SCALE_SUBTREES_CONTRA for k, _ in kern.range_t)
    if bold:
        check(launches["contra_range_bold"] == launches["contra_range"] > 0 or not contra_blocks,
              f"{name}: {launches['contra_range_bold']} of {launches['contra_range']} K6 range "
              f"launches with the bold uniforms")
        check(launches["glob_scan_bold"] == (sweeps if has_sub else 0),
              f"{name}: {launches['glob_scan_bold']} G1 sub_contra launches with the bold "
              f"uniforms in {sweeps} sweeps")
    else:
        check(launches["contra_range_bold"] == launches["glob_scan_bold"] == 0,
              f"{name}: bold launches without --bold-contra")
    _check_all_launched(name, launches)
    check(launches["plain_twins"] == 0 and launches["plain_proposals"] == 0,
          f"{name}: ran {launches['plain_twins']} plain twins and "
          f"{launches['plain_proposals']} plain proposals")
    return {k: round(launches[k] / sweeps, 2) for k in OPT_NAMES}


def _log_lines(path, *prefixes):
    """The lines of a log file that start with any of ``prefixes``; each
    prefix must start one."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    out = []
    for p in prefixes:
        found = [x for x in lines if x.startswith(p)]
        check(found, f"{os.path.basename(path)}: no line starting with '{p}'")
        out += found
    return out


def phase_optional_tutorial():
    """The optional moves through the CLI at MAIN_TAXA x CHAINS: simulate ->
    prepare full -> run --profile with OPT_FLAGS -> continue with them ->
    marginal-likelihood --profile --fiber-slide --bold-contra -> run --mc3
    --profile --fiber-slide --fiber-de (OPT_MC3_ITERATIONS iterations; the
    DE is not applied there, and says so); each checked by
    ``_opt_checked`` and, for run and continue, the carry check."""
    import numpy as np
    import torch

    from mcmcdate_tpu_torch import cli
    from mcmcdate_tpu_torch.engine.ensemble import FiberDE
    from mcmcdate_tpu_torch.engine.fast_sweep import FastSweeps
    from mcmcdate_tpu_torch.engine.stepping_stone import N_POINTS_PROF

    an = "opt"
    out = {}
    # F1's launches a sweep and F2's a round of run and continue, from their
    # counters and the sweeps and rounds counted.
    within = {}
    inside = ((FastSweeps, "sweep_once"), (FiberDE, "__call__"))
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        cli.main(["simulate", "--leaves", str(MAIN_TAXA), "--trees", str(TREES), "--out", data])
        cli.main(["prepare", "-a", an, "--rooted-tree", os.path.join(data, "time.tree"),
                  "--trees", os.path.join(data, "trees.nwk"), "--likelihood-spec", "full",
                  "--out-dir", tmp])
        common = ["--device", "cuda", "--out-dir", tmp, "--profile"]
        t0 = time.perf_counter()
        launches, (de, runner) = _counted(lambda: _de_recorded(lambda: cli.main(
            ["run", "-a", an, "--chains", str(CHAINS), "--seed", "1", "--iterations",
             str(ITERATIONS), *common, *OPT_FLAGS])), inside=inside, within=within)
        run_s = time.perf_counter() - t0
        sweeps = 60 + ITERATIONS
        per = _opt_checked("optional moves run", launches, runner, sweeps)
        lines = _log_lines(os.path.join(tmp, f"{an}.run.log"), "bold contrary kernels:",
                           "fiber node-slide phase:", "fiber-DE ensemble phase:",
                           "fiber node-slide: mean acceptance", "fiber DE: mean acceptance")
        with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
            lp_post = z["lp_post"]
        lp_err, lp_f64 = check_carried_posterior(runner, tmp, lp_post[-1], name=an,
                                                 de=de["last"])
        de_acc = int(de["accepts"])
        moved = sum(int(o.accept.sum()) for _, o in de["last"])
        log(f"[optional moves tutorial] run --profile {' '.join(OPT_FLAGS)}, {MAIN_TAXA} taxa x "
            f"{CHAINS} chains, {sweeps} sweeps in {run_s:.1f} s, median "
            f"{statistics.median(runner.sweep_seconds):.4f} s per sweep on "
            f"{torch.cuda.get_device_name(0)}; {'; '.join(lines)}; {de_acc} fiber-DE accepts, "
            f"{moved} in the rounds after the last chunk; carried log posterior within "
            f"{lp_err:.3g} (float32 vs float64: {lp_f64:.3g}); per sweep {json.dumps(per)}")
        out["run"] = launches

        t0 = time.perf_counter()
        c_launches, (de, runner2) = _counted(lambda: _de_recorded(lambda: cli.main(
            ["continue", "-a", an, "--seed", "2", "--iterations", str(CONTINUE_ITERATIONS),
             *common, *OPT_FLAGS])), inside=inside, within=within)
        cont_s = time.perf_counter() - t0
        per = _opt_checked("optional moves continue", c_launches, runner2, CONTINUE_ITERATIONS)
        lines = _log_lines(os.path.join(tmp, f"{an}.continue.log"),
                           "fiber node-slide: mean acceptance", "fiber DE: mean acceptance")
        with np.load(os.path.join(tmp, f"{an}.trace.npz")) as z:
            lp_post = z["lp_post"]
        check(lp_post.shape[0] == ITERATIONS + CONTINUE_ITERATIONS,
              f"continued trace of {lp_post.shape[0]} draws")
        c_err, _ = check_carried_posterior(runner2, tmp, lp_post[-1], name=an, de=de["last"])
        c_acc = int(de["accepts"])
        moved = sum(int(o.accept.sum()) for _, o in de["last"])
        check(de_acc + c_acc > 0, "optional moves: the fiber DE accepted nothing in run and "
              "continue")
        log(f"[optional moves tutorial] continue --iterations {CONTINUE_ITERATIONS} with the "
            f"same flags in {cont_s:.1f} s; {'; '.join(lines)}; {c_acc} fiber-DE accepts, "
            f"{moved} in the rounds after the last chunk; carried log posterior within "
            f"{c_err:.3g}; per sweep {json.dumps(per)}")
        sw, rd = within["sweep_once"], within["__call__"]
        per_run = {"fiber_slide": sw["fiber_slide"] / sw["calls"],
                   "fiber_de": rd["fiber_de"] / rd["calls"]}
        log(f"[optional moves tutorial] run and continue: {sw['calls']} sweeps, "
            f"{sw['fiber_slide']} F1 launches in them; {rd['calls']} fiber-DE rounds, "
            f"{rd['fiber_de']} F2 launches in them")
        out["continue"] = c_launches

        t0 = time.perf_counter()
        ml_flags = ("--fiber-slide", str(FIBER_SLIDE), "--bold-contra", str(BOLD_P))
        m_launches, res = _counted(lambda: cli.main(
            ["marginal-likelihood", "-a", an, "--seed", "1", "--iterations", str(ML_ITERATIONS),
             *common, *ml_flags]))
        ml_s = time.perf_counter() - t0
        check(math.isfinite(res.log_marginal_likelihood), "optional moves log Z is not finite")
        check(m_launches["fiber_slide"] > 0 and m_launches["fiber_de"] == 0
              and m_launches["glob_scan_bold"] > 0,
              f"optional moves marginal likelihood: launches {m_launches}")
        _check_ml_launches("optional moves marginal likelihood", m_launches,
                           N_POINTS_PROF - 1)
        log(f"[optional moves tutorial] marginal-likelihood --profile {' '.join(ml_flags)} in "
            f"{ml_s:.1f} s: log Z {res.log_marginal_likelihood:.4f}; F1, F2 and the bold paths "
            f"{json.dumps({k: m_launches[k] for k in OPT_NAMES})}")
        out["ml"] = m_launches

        t0 = time.perf_counter()
        mc3_flags = ("--fiber-slide", str(FIBER_SLIDE), "--fiber-de", str(FIBER_DE))
        x_launches, runner3 = _counted(lambda: cli.main(
            ["run", "-a", an + "m", "--preparation-name", an, "--chains", str(MC3_GROUPS),
             "--mc3", "--seed", "3", "--iterations", str(OPT_MC3_ITERATIONS), *common,
             *mc3_flags]))
        mc3_s = time.perf_counter() - t0
        sweeps = 60 + OPT_MC3_ITERATIONS
        check(runner3.de_move is None and x_launches["mc3_swap"] == sweeps // 2,
              f"optional moves mc3: DE {runner3.de_move}, {x_launches['mc3_swap']} M1 launches")
        per = _opt_checked("optional moves mc3", x_launches, runner3, sweeps, de=False,
                           bold=False)
        lines = _log_lines(os.path.join(tmp, f"{an}m.run.log"), "fiber DE: not applied",
                           "sampling done; swap acceptance rate")
        log(f"[optional moves tutorial] run --mc3 --profile {' '.join(mc3_flags)}, "
            f"{MC3_GROUPS} groups x 4 temperatures, {sweeps} sweeps in {mc3_s:.1f} s; "
            f"{'; '.join(lines)}; per sweep {json.dumps(per)}")
        out["mc3"] = x_launches
    return {k: sum(p[k] for p in out.values()) for k in out["run"]}, per_run


def phase_optional_full_width():
    """The three optional moves at full width: FastSweeps through
    ChainRunner on the synthetic model of BENCH_TAXA taxa x CHAINS chains
    (D = 1,997) with --bold-contra BOLD_P, --fiber-slide 1 and --fiber-de 2:
    FULL_WIDTH_SWEEPS sweeps with the rounds after the chunk and one more
    sweep whose carried log posterior is checked (counted), then chunks of
    FULL_WIDTH_SWEEPS without and with the moves in turns (without, with,
    without, with) from that state.  Logs s/sweep with and without (host
    clock, the DE rounds inside the chunk's time), the slide's and the
    DE's acceptance, F1's launches a sweep."""
    import torch

    from mcmcdate_tpu_torch import synthetic
    from mcmcdate_tpu_torch.engine import proposals as P
    from mcmcdate_tpu_torch.engine.chains import ChainRunner, RunSettings, new_key

    model, init = synthetic.build(BENCH_TAXA, 1, device="cuda")
    table = P.build_proposal_table(model.topo, model.braces, model.calibrations_available)

    def runner_of(**moves):
        return ChainRunner(model, table, RunSettings("optfull", n_chains=CHAINS, seed=1,
                                                     device="cuda", **moves),
                           log=lambda *a: None)

    t0 = time.perf_counter()
    runner = runner_of(bold_contra=BOLD_P, bold_factor=BOLD_FACTOR, fiber_slide=FIBER_SLIDE,
                       fiber_de=FIBER_DE)
    build_s = time.perf_counter() - t0
    batch, tuning = runner.init_chains(init)

    def run():
        b, k, _, _, _ = runner._run_window(batch, tuning, new_key(1), FULL_WIDTH_SWEEPS)
        return runner.kern.sweeps(b, tuning, 7, 1), k

    launches, (out, key) = _counted(run)
    first_s = runner.sweep_seconds[0]
    slide = runner._extra_accs["fiber node-slide"]
    de = runner._extra_accs["fiber DE"]
    n = FULL_WIDTH_SWEEPS + 1
    per = _opt_checked("optional moves full width", launches, runner, n, chunks=1)
    err, err64 = _check_lp("optional moves full width", model, out[0], out[1] + out[2])
    check(0 < statistics.mean(slide) < 1, f"optional full width: slide acceptance {slide}")
    check(len(de) == int(round(FIBER_DE)) and all(0 <= x <= 1 for x in de),
          f"optional full width: fiber DE acceptance {de} by round")
    plain = runner_of()
    b = out[0]
    turns = {"with": [], "without": []}
    for label, r in (("without", plain), ("with", runner), ("without", plain), ("with", runner)):
        r.sweep_seconds.clear()
        b, key, _, _, _ = r._run_window(b, tuning, key, FULL_WIDTH_SWEEPS)
        turns[label].append(r.sweep_seconds[0])
    with_s, without_s = statistics.mean(turns["with"]), statistics.mean(turns["without"])
    log(f"[optional moves full width] {BENCH_TAXA} taxa x {CHAINS} chains, D = "
        f"{model.likelihood.dim}, {len(runner.kern.fiber_classes)} colour classes of "
        f"{runner.kern.fiber_nodes} nodes (FastSweeps built in {build_s:.1f} s): "
        f"{with_s:.4f} s per sweep with --bold-contra {BOLD_P} --fiber-slide {FIBER_SLIDE:g} "
        f"--fiber-de {FIBER_DE:g} (the DE rounds in the chunk's time), {without_s:.4f} s "
        f"without (chunks of {FULL_WIDTH_SWEEPS} in turns: {json.dumps(turns)}; the counted "
        f"first chunk with them {first_s:.4f}), on {torch.cuda.get_device_name(0)}; fiber "
        f"node-slide acceptance "
        f"{statistics.mean(slide):.4f} over {len(slide)} sweeps, fiber DE "
        f"{[round(x, 4) for x in de]} by round; carried log posterior within {err:.3g} "
        f"(float32 vs float64: {err64:.3g}); per sweep {json.dumps(per)}")
    return launches


def main():
    """Run every phase; any failure raises, so the exit code is not 0."""
    import torch

    smi = phase_device()
    phase_build()
    t0 = time.perf_counter()
    results = phase_kernels()
    log(f"[kernels] all checks took {time.perf_counter() - t0:.1f} s")
    launches, seq, prep = phase_main_path()
    try:
        t0 = time.perf_counter()
        ml = phase_marginal_likelihood(prep)
        log(f"[marginal likelihood] took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ml_full, ml_times = phase_ml_full_ladder(seq)
        log(f"[ml full ladder] took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(prep, ignore_errors=True)
    full = phase_full_width()
    prior = phase_prior_only()
    sequential = phase_sequential(seq)
    uni, uni_rec, k1_10k = phase_univariate_10k()
    log(f"[ticket_scan] at {UNI_TAXA} taxa: {json.dumps(uni_rec)}")
    t0 = time.perf_counter()
    sparse = phase_sparse_tutorial()
    log(f"[sparse tutorial] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sparse_full, admm_recs = phase_sparse_full_width()
    log(f"[sparse full width] took {time.perf_counter() - t0:.1f} s")
    results.update(admm_recs)
    t0 = time.perf_counter()
    banded = phase_banded_tutorial()
    log(f"[banded tutorial] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    banded_full = phase_banded_full_width()
    log(f"[banded full width] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ham = phase_hamiltonian_tutorial()
    log(f"[hamiltonian tutorial] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ham_full = phase_hamiltonian_full_width()
    log(f"[hamiltonian full width] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mc3 = phase_mc3_tutorial()
    log(f"[mc3 tutorial] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mc3_full = phase_mc3_full_width()
    log(f"[mc3 full width] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    opt, opt_per = phase_optional_tutorial()
    log(f"[optional moves tutorial] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    opt_full = phase_optional_full_width()
    log(f"[optional moves full width] took {time.perf_counter() - t0:.1f} s")
    check("jax" not in sys.modules, "the port imported jax")
    check(not [m for m in sys.modules if m == "mcmcdate_tpu" or m.startswith("mcmcdate_tpu.")],
          "the port imported the JAX package")

    name = torch.cuda.get_device_name(0)
    paths = {"main": launches, "full_width": full, "prior_only": prior,
             "sequential": sequential, "univariate_10k": uni, "sparse_tutorial": sparse,
             "sparse_full_width": sparse_full, "marginal_likelihood": ml,
             "ml_full_ladder": ml_full, "banded_tutorial": banded,
             "banded_full_width": banded_full, "hamiltonian_tutorial": ham,
             "hamiltonian_full_width": ham_full, "mc3_tutorial": mc3, "mc3_full_width": mc3_full,
             "optional_tutorial": opt, "optional_full_width": opt_full}
    for p, n in paths.items():
        if not p.startswith(("hamiltonian", "mc3")):
            check(all(n[k] == 0 for k in (*NUTS_NAMES, "nuts_product")),
                  f"the {p} path, without --hamiltonian, launched a NUTS kernel")
        if not p.startswith(("mc3", "optional")):
            check(n["mc3_swap"] == 0, f"the {p} path, without --mc3, launched M1")
        if not p.startswith("optional"):
            check(all(n[k] == 0 for k in OPT_NAMES),
                  f"the {p} path, without the optional moves' flags, launched "
                  f"{ {k: n[k] for k in OPT_NAMES} }")
    record = {"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep,
             launches=paths[RECORD_PATH.get(k, "main")][k],
             launches_by_path={p: n[k] for p, n in paths.items()},
             **results[k]) for k, src, rep in KERNELS
    ]}
    t3 = next(r for r in record["kernels"] if r["name"] == "ticket_scan")
    t3["launches_by_kernel"] = {p: {k: n[f"ticket_scan_{k}"] for k in ("light", "heavy")}
                                for p, n in paths.items()}
    t3["records_10k"] = uni_rec
    next(r for r in record["kernels"] if r["name"] == "prior_terms")["record_10k"] = k1_10k
    for r in record["kernels"]:
        if r["name"] in results["tempered"]:
            r["tempered"] = results["tempered"][r["name"]]
        if r["name"] == "cascade_seed":
            r["ml_full_ladder"] = ml_times
        # K6's range mode and G1 with the bold mixture's uniforms, beside
        # the same calls without them (check_bold).
        if f"{r['name']}_bold" in results["bold"]:
            r["bold"] = results["bold"][f"{r['name']}_bold"]
        # F1's launches a sweep and F2's a round, counted on run and
        # continue of the optional moves tutorial.
        if r["name"] == "fiber_slide":
            r["launches_a_sweep"] = opt_per["fiber_slide"]
        if r["name"] == "fiber_de":
            r["launches_a_round"] = opt_per["fiber_de"]
    # The NUTS gradient's product z = r P: a library call (cuBLAS), not a
    # hand-written kernel, so a line of its own ("plain_ms": the float64
    # product; "max_abs_err": against it, relative to its largest entry).
    log("[nuts product] " + json.dumps(dict(
        name="nuts_product", route="library (torch.mm, cuBLAS)",
        source="mcmcdate_tpu_torch/engine/hmc.py", replaces="mcmcdate_tpu/engine/hmc.py:118",
        launches=paths["hamiltonian_full_width"]["nuts_product"],
        launches_by_path={p: n["nuts_product"] for p, n in paths.items()},
        **results["nuts_product"])))
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
