"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels of ``multigrid_tpu_torch/csrc`` from the
sources, holds every kernel against its plain PyTorch version on the card,
then drives the port's paths and checks each against the reference's
convergence rows:

* poisson_cube (FE_Q(4), 3-D brick, f32 V-cycle inside f64 FMG and
  V-cycle-preconditioned CG) at size 64, 16,974,593 dofs;
* poisson_dg (SIP-DG, hermite p = 4, outer f64 CG preconditioned by DG
  Chebyshev smoothing around the FE_Q V-cycle) at size 48, 13,824,000 DG
  dofs, rtol 1e-9;
* poisson_dg_plain (the same SIP-DG system, hermite p = 4, solved by
  pure-DG h-multigrid: every level's Chebyshev step ``dg_cheb<float>``,
  every V-cycle residual ``dg_apply<float>``, the outer CG's A·p
  ``dg_apply<double>``) at size 48, five DG levels 3^3 -> 48^3 cells,
  rtol 1e-9: its L2 error and solution against poisson_dg's, the pinned
  3-D anchors of tests/test_dg_multigrid.py:80-82, the
  variable-coefficient operator's L2 order at sizes 12 and 24, and one
  small row of each DG benchmark driver (``matvec_dg``,
  ``matvec_dg_cheby``, ``solver_dg``);
* solver_dg at full width (gauss p = 4, 64^3 cells, 32,768,000 DG dofs, 50
  CG iterations): the fused row on ``dg_cg<double>`` and
  ``dg_jacobi_cg<double>`` with the CG scalars on the card and no host
  sync inside its loop (PyTorch's sync debug mode raises on one), the
  face-based row and the unfused row, both cell rows against the face row
  at 1e-9, the fusion speedup, each row's launches an iteration, and each
  fused kernel timed at this grid beside its bound;
* the general-geometry path (``GeneralMultigridSolver``: mapped
  multiblock meshes, plain PyTorch operators and transfers, the outer
  f64 CG on the CG kernels): the six shell anchors of
  tests/test_shell_anchors.py:26-33 on the card; poisson_shell's top row
  at maxsize 2,000,000 (``--cycles 9``; FE_Q(4), 6-block shell, 5 levels,
  1,597,570 dofs) in mixed precision, its CG iterations, FMG L2 and
  reduction those of the JAX package's ladder, its CG solution bit for
  bit the same in two solves, and in
  pure double with fourth-kind Chebyshev (:data:`PD_LEVELS` levels);
  minimal_surface (Newton, 2-D disc) at 2 levels, degree 2, against the
  same solve on the CPU, and one degree-4 row; ``poisson_cube --deform``
  at 2 and 3 levels, degree 3;
* the curved DG-plain path (``poisson_dg_plain --deform 0.05``: per-point
  geometry, plain PyTorch levels, the outer f64 CG on the CG kernels): the
  512- and 4096-dof rows of every element type, p = 3, on the card against
  the CPU and the JAX driver's anchors; hermite p = 4 at size 24,
  1,728,000 DG dofs, four levels, rate < 0.35, its frac its those of
  the first card run and its L2 the affine DG-plain row's, with its set-up
  seconds and peak memory; one ``matvec_dg --impl curved`` row in f64 and
  f32;
* poisson_l (adaptive hanging-node meshes, FE_Q(2), plain PyTorch with
  deterministic scatters, the outer f64 CG on the CG kernels): the four
  ``--initial 5`` anchor cycles on the card, each forest also solved on
  the CPU, and whether the card's Kelly marking parts from the CPU's; the
  first adaptive row from ``--initial 7`` (197,633 dofs; the rows went on
  past 1,000,000 until the script neared its time limit), its
  iterations and reduction those of the port on the CPU, its CG solution
  bit for bit the same in three solves; a ``--dim 3
  --initial 3`` cycle pair; a ``--local-smoothing --initial 7`` row
  (197,633 dofs).  The CG kernels are held against their plain versions
  at the vector lengths these two paths give them;
* poisson_dg at p = 8 and 9 and poisson_dg_plain at p = 8 (3-D, hermite,
  n_pre = n_post = 3, rtol 1e-9), the DG kernels' degrees above p = 7:
  the rows of 2^3 and 4^3 cells on the card against the JAX package's
  rows (2^3 also against the port on the CPU), then 24^3 cells (10,077,696 / 13,824,000 DG
  dofs; poisson_dg over the FE_Q(8) / FE_Q(9) hierarchy on brick_kron p =
  8 / 9, poisson_dg_plain on four DG levels 3^3 -> 24^3): frac its within
  one of the CPU's size-12 row, the rate in a band from the CPU ladder,
  the L2 plateau, poisson_dg_plain's solution and L2 poisson_dg's;
* poisson_cube at p = 8 (32^3 cells, 257^3 nodes) and p = 9 (28^3 cells,
  253^3 nodes), brick_kron's degrees above the main path's: set-up, FMG
  and CG, the CG its within one of the CPU's on the 4^3 mesh;
* p = 10 and 16, the top of the JAX package's degree sweep: poisson_cube
  on 24^3 cells (13,997,521 dofs) and 16^3 (16,974,593), poisson_dg on
  20^3 cells (10,648,000 DG dofs) and 12^3 (8,489,664), poisson_dg_plain
  on 20^3 at p = 10, every 3-D level on the hand kernels (brick_kron's
  z-slab march of ``brick_kron_wide*.cu``, the DG pencils of
  ``dg_pencil_wide*.cu``): each path's size-2 row on the card against the
  JAX row pinned in ``WIDE_ANCHORS`` (its within one, frac its and L2 to
  ``WIDE_AGREE``), then the full-width row (the cube's CG its within one
  of its size-2 row's, CG L2 below ``L2_BOUND``; the DG rows' frac its
  within one and rates within a factor of two of the first card run,
  ``WIDE_DG_CARD``, L2 the DG plateau, DG-plain's solution poisson_dg's
  to 1e-5);
* 2-D poisson_dg_plain, the reference program's setting (p = 3; the DG
  kernels are 3-D, so the levels run the plain operator, "(plain)"): the
  4096- and 16,384-dof rows of every kind on the card against the CPU,
  then hermite at 3,211,264 and 4,194,304 DG dofs; ``matvec_dg`` in f64
  at p = 8, 10 and 16 (``dg_apply<double>``) and the "(plain)" row at p =
  17 (above the DG kernels' degree), each checked against the face-based
  operator;
* poisson_cube --dim 2 (the plain operator on the levels): 32^2 cells on
  the card against the CPU, then 512^2 cells (4,198,401 dofs); poisson_dg
  --dim 2: 16^2 cells against the CPU, then 320^2 cells (2,560,000 DG
  dofs);
* the single-device utils: ``poisson_cube --output`` (2-D, 16,641 nodes)
  read back; the memory report after the set-up of poisson_cube at size
  128 (135,005,697 dofs), its CG solution through a checkpoint file and
  back bit for bit, then its FMG and V-cycle reduction;
* poisson_cube on ranks of ``torch.distributed`` sharing the card
  (``parallel.distributed.DistributedMultigrid``, boxes of cells with 2p
  ghost planes along each split axis, gloo with the planes staged through
  pinned host memory): 2 z-slab ranks at size 128, a 2 x 2 (z x y) grid
  at size 64, and the 2-D cube (size 64, 4,198,401 dofs, plain levels)
  on 2 x 2, FMG and CG (best of 2), each held to the single-device row of
  this run (cg_its 8; CG reduction, V-cycle reduction and FMG L2 within
  3%; the CG solution within ``RANKS_SOL_BAR`` of max|u|; two CG solves
  bit for bit), the owned nodes of the distributed 3-D ``vmult`` and
  ``apply`` in float and double (on 2 x 2 the corners near both cuts
  included) against ``BrickLaplace`` on the whole grid bit for bit, the
  exchange share of the f64 ``vmult`` and its bytes a refresh by stage,
  and the same vmult of ``HaloLaplace`` on the finest cuts in the overlap
  schedule (``parallel.halo.SplitApply``: the send regions first, their
  exchange in flight while the interior runs) with the refresh alone,
  the hidden share and the plan's overlappable fraction, its box equal to
  apply-then-refresh, every node, bit for bit; one rank on nccl against
  the single-device solver's bits.  Before the ranks, in one process:
  the overlap schedule at p = 8 in float32 where the sub-boxes run
  ``brick_kron``'s cell form and the whole box the layer march (bit for
  bit),
  and ``LaplaceOperator`` with a ``SymCoef`` on the card against
  ``DiagCoef`` and the CPU.  The kernels' launches are summed over the
  ranks;
* the DG solvers on ranks sharing the card
  (``parallel.distributed.DistributedMultigridDG``: cell slabs with ghost
  cell layers on the DG pencil kernels): poisson_dg (hermite p = 4, n_pre
  3) at size 64 (32,768,000 DG dofs) on 2 z-slab ranks, its FE_Q
  hierarchy on F-1's slabs, poisson_dg_plain (gauss p = 4) at size 48
  (13,824,000 DG dofs) on a 2 x 2 grid, and poisson_dg at size 32
  (4,096,000 DG dofs) on 2 x 2, every FE_Q level above the coarsest two
  split, each against its one-device row of this run (frac its
  within 5%, rate within 1e-3 and L2 within 1e-6 relative, the CG solution
  within ``RANKS_SOL_BAR`` of max|u|, two CG solves bit for bit) and
  ``PERF.md`` section 2's DG and DG-plain guards; the owned cells of
  ``dg_apply<double>``, ``dg_residual<float>`` and ``dg_cheb<float>`` on
  the slab against ``DGOperator`` on the whole grid bit for bit (the
  traces wire) and against the plain algorithm; the exchange split of the
  13.8M DG-plain finest level's f32 apply and the bytes of a refresh on
  both wires; ``HaloDGLaplace2D`` on a 2 x 2 rank grid at 48^3 cells (p =
  4) against ``DGOperator`` on the whole grid (the traces wire bit for
  bit, the hermite wire within ``DG_HERMITE_BAR`` of max|y| in f64); one
  nccl rank of each DG solver against the single-device solver's bits;
  the 2-D DG solvers (plain levels) on 2 z ranks and on 2 x 2 at the
  sizes of the one-device 2-D rows of this run (poisson_dg_plain hermite
  p = 3 at 4,194,304 DG dofs, poisson_dg p = 4 at 2,560,000), each held
  against that row as the 3-D rows are and to its path's guards, the
  slab passes within ``time_ranks.PLAIN_ROUTE_BAR`` of the whole grid's.
  The cube and DG rows of one world size share a launch of the ranks, and
  the nccl rank runs both solvers.

``brick_kron`` (float and double, every mode) is held at every compiled
degree (p = 1..16; at p = 10..16 the z-slab march of
``brick_kron_wide*.cu``, on small grids, timed at p = 10 and 16 on the
cube rows' node grids, its outputs bit for bit as ``KRON_WIDE_DIGESTS``
pins them; at p = 8, 9 in the form ``laplace_kernel.brick_form``
picks for each grid: the cell form on the small grids and in double, the
layer march on the large float ones, whose four modes at the cube rows'
node grids are also held against ``brick_kron_reference`` and against
the z-slab march bit for bit), also at the coarse grids of the p = 8, 9
hierarchies (64^3 and 28^3 nodes at p = 9, 25^3 at p = 8), and the DG
pencil kernels (``dg_apply`` and
``dg_residual`` in float and double, ``dg_cheb<float>``) at theirs (p =
1..16; at p = 10..16 the in-place pencils of ``dg_pencil_wide*.cu``,
whose tiles are printed after the build, timed at p = 10 and 16 on the
grids of their paths; the step at p = 8, 9 and the double apply at p = 8
are the kernels
of ``csrc/dg_pencil_high.cu``, whose tile,
registers and spill are printed after the build, a spill failing the run,
also on ``dg_kernel.HIGH_CELLS``: one-cell axes, ragged pencils, many
pencils), the DG
kernels on x axes that do not fill a pencil or have one
cell, against the plain operator and the face-based one
(``ops/dg_face.py``); the fused CG's ``dg_cg<double>`` and
``dg_jacobi_cg<double>`` at p = 1..9, their degrees (also on
``dg_kernel.MARCH_CELLS``,
the ends of dg_cg's z march) and timed at 13,824,000 DG dofs against their plain
versions (``vmult_with_cg_update`` and ``JacobiTransformed.vmult``).  Then
the DG kernels' bits: ``dg_kernel.kernel_digests`` (every mode of every
DG kernel at p = 1..16 in every kind, on seeded inputs) must equal
:data:`DG_DIGESTS` (those of tests/test_torch_cuda.py) key for key, and a
3-D DG level at p = 17 is refused on the card ("no DG kernel").

Every phase raises on a miss; there is no CPU path.

Output: the card line (``nvidia-smi``), per-phase numbers, one JSON line
with the kernels (device kernels launched during the paths' solves, as a
trace counts them: one brick_kron call 1, one CG reduction 2, one DG
kernel call 1, one fused CG pass 2; ``launches`` sums the paths, ``launches_by_path`` gives
each, and brick_kron's by kernel and node grid under "<kernel> ZxYxX";
the ``... p=8``, ``... p=9``, ``... p=10`` and ``... p=16`` rows are
brick_kron and the DG kernels at those degrees, timed at the cube rows'
node grids and the DG rows' grids and counted on the paths of that degree
(the cube and DG rows, the
p = 8 ``matvec_dg`` row; the p = 8, 9 DG and DG-plain solves must run
every step and the p = 8 double apply in ``dg_pencil_high.cu``'s kernels,
"<kernel> high" in their launches, and the p = 4 DG paths none), the ``... p=9 64^3`` rows and the like
brick_kron at a coarse grid, timed there and counted at that grid on the
paths of its degree (the p = 9 cube row's and the p = 8, 9 poisson_dg
rows' coarse steps must be there), the other rows count every other
path; the rows
``brick_kron<float>``, ``brick_kron<double>``,
``dg_apply<float>`` and ``dg_apply<double>`` count the kernel's A·x modes
(apply, the brick's vmult, residual) and time apply, with the residual
mode's numbers beside them under ``residual_*``; max error against the
plain version;
time of kernel, plain version and, where one PyTorch call computes the same
function, that call; the least time the card could take, from the bytes
and operations the function needs), the card line again and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SIZE = 64              # poisson_cube size: 64^3 cells, 16,974,593 dofs
# reference convergence row at size 64 (p = 4, 2 V-cycles, 2+2 smoothing)
CG_ITS = 8
CG_REDUCTION = 6.863e-2
VCYCLE_REDUCTION = 0.1375
ROW_TOL = 0.03
L2_BOUND = 1e-7
DG_SIZE = 48           # poisson_dg size: 48^3 cells, 13,824,000 DG dofs
DG_RTOL = 1e-9
# reference-parity poisson_dg rows at rtol 1e-9, 1.0M-2.7M DG dofs
# (docs/tpu_r5/poisson_dg_tight.log): L2 plateau 0.100686 (no weak
# boundary data in the rhs), 5.47-5.54 its, rate 0.0226-0.0237
DG_L2, DG_L2_TOL = 0.10069, 1e-3
DG_RATE = (0.018, 0.032)
DG_ITS = (5.2, 6.2)
# poisson_dg_plain: the size-48 solve holds the poisson_dg solution of the
# same discrete system (both at rtol 1e-9): L2 error to 1e-5 relative, the
# solution to 1e-5 of max|u|; rate below the JAX tests' bar
# (tests/test_dg_multigrid.py:47)
PLAIN_AGREE = 1e-5
PLAIN_RATE = 0.35
# pinned 3-D anchors, cube(2, 0, 1, n_ref), p = 3, hermite, tol 1e-10
# (tests/test_dg_multigrid.py:80-82): n_ref -> (frac its, rate, L2)
PLAIN_ANCHORS = {1: (10.449, 0.1104, 2.785766e-3),
                 2: (10.793, 0.1184, 2.622445e-4)}
PLAIN_ANCHOR_TOL = (0.02, 0.05, 1e-4)
# variable coefficient, p = 3 at sizes 12 and 24: the bars of
# tests/test_dg_varcoeff.py:130,164 (rate < 0.5, L2 order > p + 0.6)
VC_SIZES, VC_DEGREE, VC_RATE = (12, 24), 3, 0.5

# the shell anchors (tests/test_shell_anchors.py:26-33; degree 3, n_pre =
# n_post = 3): (mesh, n_levels, pure double) -> (dofs, FMG L2, cg_its, CG
# reduction, CG L2), held as there: its exactly, reductions to 2%, FMG L2
# to 1e-3, CG L2 to 1e-5
SHELL_ANCHORS = {
    ("shell6", 2, False): (1526, 2.346556e-01, 15, 0.232046, 1.823688e-01),
    ("shell6", 2, True): (1526, 3.355221e-01, 22, 0.377363, 1.823688e-01),
    ("shell12", 2, False): (3038, 2.150496e-01, 13, 0.191005, 1.319676e-01),
    ("shell12", 2, True): (3038, 2.436254e-01, 20, 0.342541, 1.319676e-01),
    ("shell6", 3, False): (11258, 7.347376e-02, 16, 0.264773, 3.525010e-02),
    ("shell6", 3, True): (11258, 1.607104e-01, 26, 0.445591, 3.525010e-02),
}
SHELL_ANCHOR_TOL = (1e-3, 0.02, 1e-5)     # FMG L2, reductions, CG L2
SHELL_LEVELS = 5       # 6-block shell, FE_Q(4): 1,597,570 dofs
# the converged (rtol 1e-9) CG L2 error is the discretization's, whatever
# the chip: the JAX package's ladder rows read 1.40080e-5 at 1,597,570
# dofs and 4.00663e-4 at 202,818 (docs/tpu_r3/shell_df64_resume.log,
# docs/tpu_r4/shell_blk.log, cycles 8 and 6)
SHELL_CG_L2 = {5: 1.40080e-5, 4: 4.00663e-4}
SHELL_CG_L2_TOL = 1e-3
# the pure-double fourth-kind row: 4 levels, 202,818 dofs (5 levels spent
# 16 s in set-up on one H100)
PD_LEVELS = 4
# CG iterations, held within one: the 5-level mixed row, the JAX package's
# ladder (docs/tpu_r4/shell_blk.log, cycle 8: 24 its, FMG L2 1.919187e-2,
# reduction 0.413267, both also held at the anchors' bars); pure double,
# which that ladder never reached, the port's own runs (34 its at 5 levels
# on the card, PERF.md; 34 at 4 levels on the CPU)
SHELL_ITS = {(5, False): 24, (5, True): 34, (4, True): 34}
SHELL_MIXED = (1.919187e-2, 0.413267)     # FMG L2, reduction
# minimal_surface at 2 levels, degree 2, card against CPU: the same Newton
# and CG counts, each residual norm to 1e-6 of itself or of the Newton
# tolerance, whichever is larger (the last norm sits at rounding level)
MS_TOL, MS_AGREE = 1e-9, 1e-6
# the degree-4 rows: the driver's --levels 3 --degree 4 --cycles 3, Newton
# from cold on 3 levels, then warm on 4 and 5 (1313 -> 20,609 dofs); a cold
# start on 4 levels stalls in the JAX package as in the port
MS_ROW = (3, 3, 4)     # (cycles, first levels, degree)
# poisson_cube --deform, degree 3, at 2 and 3 levels: the bars of
# tests/test_shell_minimal_surface.py:80-81
DEFORM_ITS, DEFORM_RATE = 9, 3.2

# brick_kron above the main path's degree (p = 8, 9: the reference's
# poisson_cube dispatches p = 1..9): cube size -> degree, 32^3 cells at p = 8
# (257^3 nodes, the node grid of the size-64 p = 4 row) and 28^3 at p = 9
# (253^3); each row's CG its within one of the CPU's on the 4^3 mesh
HIGH_DEGREE_SIZES = {8: 32, 9: 28}
# brick_kron's coarse grids at p = 8, 9 (degree -> cells of the coarse
# level): the p = 9 cube row's 7^3 cells (64^3 nodes, about 235 Chebyshev
# steps a V-cycle) and poisson_dg's FE_Q(p) coarse level at size 24, 3^3
# cells (28^3 / 25^3 nodes); checked and timed under " p=<p> <Z>^3"
HIGH_DEGREE_COARSE = {9: (7, 3), 8: (3,)}
HIGH_DEGREE_SMALL = 4
# 2-D DG-plain (the reference program's setting, p = 3, rtol 1e-9): the
# rows of 16^2 and 32^2 cells (sizes 2, 4) of every kind on the card
# against the CPU (its within one, frac its and L2 to 1%); hermite at
# 448^2 and 512^2 cells (sizes 56, 64; 3,211,264 and 4,194,304 DG dofs),
# rate below PLAIN_RATE, frac its within one of each other
DG2_DEGREE, DG2_SMALL, DG2_LARGE = 3, (2, 4), (56, 64)
DG2_AGREE = 0.01
# matvec_dg in f64, checked against the face-based operator at matvec_dg's
# bar (degree -> refinement steps): the kernel rows at p = 8, 10 and 16
# (2,985,984, 2,725,888 and 2,515,456 DG dofs) run dg_apply<double>; above
# the DG kernels' degree, p = 17 (2,985,984), the plain row
MATVEC_PLAIN = {17: 9}
MATVEC_KERNEL = {8: 12, 10: 11, 16: 9}
# poisson_dg (DG over the FE_Q(p) hierarchy) and poisson_dg_plain at the DG
# kernels' degrees above p = 7 (3-D, hermite, n_pre = n_post = 3, rtol
# 1e-9): the rows of 2^3 and 4^3 cells (sizes 2, 4) on the card against the
# JAX package's rows (DG_HIGH_ANCHORS) and, at DG_HIGH_CPU_SMALL, the port
# on the CPU (at size 4 its set-up held the script back): its within one,
# frac its and L2 to DG_HIGH_AGREE; then the size-24 row (24^3
# cells: 10,077,696 DG dofs at p = 8, 13,824,000 at p = 9): frac its
# within one of the port's largest CPU row (size 12, DG_HIGH_CPU), the rate
# in DG_HIGH_RATE (half the smallest to twice the largest rate of the CPU
# ladder, sizes 2-12), the L2 error the DG plateau (DG_L2 +- DG_L2_TOL);
# poisson_dg_plain's L2 and solution poisson_dg's of the same degree and
# size to PLAIN_AGREE, its rate below PLAIN_RATE
DG_HIGH_SIZE, DG_HIGH_SMALL, DG_HIGH_AGREE = 24, (2, 4), 0.01
DG_HIGH_CPU_SMALL = (2,)
DG_HIGH_PATHS = (("poisson_dg", 8), ("poisson_dg", 9), ("poisson_dg_plain", 8))
# (path, p) -> {size: (frac its, rate, L2)}: the JAX solvers on the CPU
# (MultigridSolverDG with dp_impl="native", MultigridSolverDGPlain)
DG_HIGH_ANCHORS = {
    ("poisson_dg", 8): {2: (5.336294, 2.057957e-2, 1.007506877e-1),
                        4: (5.537307, 2.369524e-2, 1.006858953e-1)},
    ("poisson_dg", 9): {2: (5.497613, 2.306353e-2, 1.006835780e-1),
                        4: (6.386804, 3.898023e-2, 1.006857565e-1)},
    ("poisson_dg_plain", 8): {2: (11.620473, 1.680757e-1, 1.007506877e-1),
                              4: (12.732016, 1.963905e-1, 1.006858953e-1)},
}
# the port's CPU ladder (sizes 2, 4, 6, 8, 12): frac its at size 12, and
# the rate band; rates 0.02058-0.02982 (poisson_dg p = 8), 0.02305-0.04800
# (p = 9), 0.1681-0.2378 (poisson_dg_plain p = 8)
DG_HIGH_CPU = {("poisson_dg", 8): 5.899683, ("poisson_dg", 9): 6.824563,
               ("poisson_dg_plain", 8): 14.426112}
DG_HIGH_RATE = {("poisson_dg", 8): (0.01029, 0.05964),
                ("poisson_dg", 9): (0.01152, 0.09600),
                ("poisson_dg_plain", 8): (0.08404, 0.4756)}
# brick_kron and the DG pencils at p = 10..16, the top of the JAX
# package's degree sweep (tests/test_degree_sweep.py): every degree held
# against its plain version on small, one-cell-axis and ragged grids, the
# z-slab march in both types (brick_kron_wide*.cu) and the in-place
# pencils (dg_pencil_wide*.cu); timed at p = 10 and 16 on the grids of
# their paths: poisson_cube at size 24 (241^3 nodes) and 16 (257^3),
# poisson_dg at size 20 (10,648,000 DG dofs) and 12 (8,489,664), and
# poisson_dg_plain at size 20 (p = 10)
WIDE_DEGREES = tuple(range(10, 17))
WIDE_CUBE_SIZES = {10: 24, 16: 16}
WIDE_DG_SIZES = {10: 20, 16: 12}
WIDE_DG_PATHS = (("poisson_dg", 10), ("poisson_dg", 16),
                 ("poisson_dg_plain", 10))
WIDE_SMALL = 2
# (path, p) -> the JAX package's row at size 2 on the CPU: poisson_cube
# (MultigridSolver, n_pre = n_post = 2, 2 V-cycles): (CG its, CG
# reduction, CG L2); poisson_dg (MultigridSolverDG, dp_impl="native") and
# poisson_dg_plain (MultigridSolverDGPlain), hermite, n_pre = n_post = 3,
# rtol 1e-9: (frac its, rate, L2).  The card's size-2 rows meet them with
# its within one, frac its and L2 to WIDE_AGREE: DG_HIGH_AGREE's 1% at p =
# 10; 2% at p = 16, where the f32 V-cycle over FE_Q(16) moves the frac its
# with the order of its sums (the port on the CPU read 9.2142 on four
# threads, the card 9.1004, JAX 9.2533; the L2 errors agree to 1e-12)
WIDE_AGREE = {10: DG_HIGH_AGREE, 16: 0.02}
WIDE_ANCHORS = {
    ("poisson_cube", 10): {2: (9, 8.154445e-2, 7.166941394e-5)},
    ("poisson_cube", 16): {2: (13, 1.824618e-1, 1.116605566e-9)},
    ("poisson_dg", 10): {2: (5.932024, 3.039565e-2, 1.006862210e-1)},
    ("poisson_dg", 16): {2: (9.253329, 1.065067e-1, 1.006856908e-1)},
    ("poisson_dg_plain", 10): {2: (12.658460, 1.945419e-1, 1.006862211e-1)},
}
# the full-width rows of this script's first run on the card (NVIDIA H100
# 80GB HBM3, 700 W), a guard against a later change: poisson_cube CG its
# within one of the size-2 row, CG L2 below L2_BOUND; the DG rows' frac
# its within one of these, their rates within a factor of two, their L2
# the DG plateau (DG_L2 +- DG_L2_TOL), poisson_dg_plain's solution and L2
# poisson_dg's to PLAIN_AGREE
WIDE_DG_CARD = {("poisson_dg", 10): (6.914969, 4.994312e-2),
                ("poisson_dg", 16): (10.785524, 1.464024e-1),
                ("poisson_dg_plain", 10): (24.719500, 4.324291e-1)}
# the 2-D brick: size 4 (32^2 cells) card against CPU (its exact, V-cycle
# and CG reductions to 2%), then size 64 (512^2 cells, 4,198,401 dofs):
# cg_its 8 and the reductions within ROW_TOL of the top row of
# ``poisson_cube 4 200000 1100000 --dim 2 --device cpu`` (1,050,625 dofs;
# the rows from 66,049 dofs up read 8 its, 0.0678-0.0686, 0.149-0.151)
CUBE2_SMALL, CUBE2_SIZE = 4, 64
CUBE2_CG_REDUCTION, CUBE2_VCYCLE_REDUCTION = 6.784e-2, 0.1508
# poisson_dg --dim 2, hermite p = 4, n_pre 3, rtol 1e-9: size 2 card against
# CPU (frac its and rate to 2%, L2 to 1e-6), size 40 (320^2 cells,
# 2,560,000 DG dofs) at the DG bars and the 2-D L2 plateau of the CPU rows
# (0.136463 at 1,600 to 25,600 DG dofs)
DG2D_SMALL, DG2D_SIZE, DG2D_L2 = 2, 40, 0.136463
# solver_dg at full width: gauss p = 4 on 2^(18/3) = 64 cells an axis
# (32,768,000 DG dofs), 50 CG iterations, the three rows (fused, face,
# unfused) held against the face row at solver_dg's 1e-9
SOLVER_DG = dict(degree=4, kind="gauss", n_cell_steps=18, n_iterations=50)
SOLVER_DG_FUSED = {"dg_cg<double>", "dg_jacobi_cg<double>"}
# the 135M cube (size 128): the memory report after its set-up, one CG
# solve, its solution through a checkpoint file and back bit for bit
MEM_SIZE = 128
# poisson_cube --output, 2-D size 4 (16,641 nodes, under the vtk guard)
VTK_SIZE = 4

# the card's peak rates for the bound (H100 SXM, NVIDIA data sheet):
# HBM3 bandwidth; fp32 outside the tensor cores; fp64 on the tensor cores
# (67 TFLOP/s, twice the 34 of the fp64 units), the higher of the two: a
# bound is the least time the card could take, whatever units a kernel
# of the port happens to use
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
# brick_kron's bars against the dense plain f64 path, of max|y| (apply,
# vmult, residual) and of max|out| (the Chebyshev step, where f2 / diag
# amplifies the rounding of A x), and the value type's name
KRON_BARS = {torch.float32: ("float", 2e-6, 3e-6),
             torch.float64: ("double", 1e-13, 1e-12)}

BRICK = "multigrid_tpu_torch/csrc/brick_kron.cuh"
PENCIL = "multigrid_tpu_torch/csrc/dg_pencil.cuh"
# p = 10..16: the z-slab march's and the in-place pencils' translation
# units, by type (the DG ones at p = 10..13, then 14..16)
BRICK_WIDE = {"float": "multigrid_tpu_torch/csrc/brick_kron_wide.cu",
              "double": "multigrid_tpu_torch/csrc/brick_kron_wide_f64.cu"}
PENCIL_WIDE = {("float", False): "multigrid_tpu_torch/csrc/dg_pencil_wide.cu",
               ("float", True):
                   "multigrid_tpu_torch/csrc/dg_pencil_wide_top.cu",
               ("double", False):
                   "multigrid_tpu_torch/csrc/dg_pencil_wide_f64.cu",
               ("double", True):
                   "multigrid_tpu_torch/csrc/dg_pencil_wide_top_f64.cu"}
# the DG pencils at p = 8, 9: a design of their own
PENCIL_HIGH = "multigrid_tpu_torch/csrc/dg_pencil_high.cu"
EPILOGUE = "multigrid_tpu_torch/csrc/cheb_epilogue.cu"
FUSED_CG = "multigrid_tpu_torch/csrc/dg_cg_f64.cu"
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "brick_kron<double>": (BRICK, "multigrid_tpu/ops/pallas_windowed.py:340"),
    "brick_kron_cheb<double>": (BRICK,
                                "multigrid_tpu/ops/pallas_windowed.py:340"),
    "brick_kron<float>": (BRICK, "multigrid_tpu/ops/pallas_windowed_sp.py:408"),
    "brick_kron_cheb<float>": (BRICK,
                               "multigrid_tpu/ops/pallas_windowed_sp.py:408"),
    "cheb_epilogue<float>": (EPILOGUE,
                             "multigrid_tpu/ops/pallas_windowed_sp.py:408"),
    "cheb_epilogue<double>": (EPILOGUE,
                              "multigrid_tpu/ops/pallas_windowed.py:340"),
    "cg_update": ("multigrid_tpu_torch/csrc/cg_vec.cu",
                  "multigrid_tpu/ops/pallas_pairvec.py:149"),
    "cg_dot": ("multigrid_tpu_torch/csrc/cg_vec.cu",
               "multigrid_tpu/ops/pallas_pairvec.py:212"),
    "cg_xpay": ("multigrid_tpu_torch/csrc/cg_vec.cu",
                "multigrid_tpu/ops/pallas_pairvec.py:149"),
    "dg_apply<double>": (PENCIL, "multigrid_tpu/ops/pallas_dg.py:639"),
    "dg_apply<float>": (PENCIL, "multigrid_tpu/ops/pallas_dg.py:438"),
    "dg_cheb<float>": (PENCIL, "multigrid_tpu/ops/pallas_dg.py:490"),
    # solver_dg's fused CG row: the TPU side is XLA's fusion of the whole
    # CG loop under one jit (the JAX driver's make_cg), no Pallas kernel
    "dg_cg<double>": (FUSED_CG, "experiments/solver_dg.py:51"),
    "dg_jacobi_cg<double>": (FUSED_CG, "experiments/solver_dg.py:51"),
}
# brick_kron at p = 8 and 9, timed at their cube rows' node grids and
# their coarse grids, and the DG kernels at p = 8 and 9, timed at the
# size-24 DG grids; each counted on the paths of its degree only (an entry
# of a coarse grid: the launches at that node grid)
BRICK_NAMES = ("brick_kron<double>", "brick_kron_cheb<double>",
               "brick_kron<float>", "brick_kron_cheb<float>")
for _p in HIGH_DEGREE_SIZES:
    for _name in BRICK_NAMES:
        KERNELS[f"{_name} p={_p}"] = KERNELS[_name]
    for _name in ("dg_apply<double>", "dg_apply<float>", "dg_cheb<float>"):
        KERNELS[f"{_name} p={_p}"] = KERNELS[_name]
    for _c in HIGH_DEGREE_COARSE[_p]:
        for _name in BRICK_NAMES:
            KERNELS[f"{_name} p={_p} {_c * _p + 1}^3"] = KERNELS[_name]
# the DG pencils that run dg_pencil_high.cu (dg_kernel.HIGH_DEGREES)
for _name, _degrees in (("dg_apply<double>", (8,)),
                        ("dg_cheb<float>", (8, 9))):
    for _p in _degrees:
        KERNELS[f"{_name} p={_p}"] = (PENCIL_HIGH, KERNELS[_name][1])
# p = 10 and 16: brick_kron at the cube rows' node grids, the DG pencils
# at the DG rows' grids, each counted on the paths of its degree
for _p in WIDE_CUBE_SIZES:
    for _name in BRICK_NAMES:
        KERNELS[f"{_name} p={_p}"] = (
            BRICK_WIDE["float" if "<float>" in _name else "double"],
            KERNELS[_name][1])
    for _name in ("dg_apply<double>", "dg_apply<float>", "dg_cheb<float>"):
        KERNELS[f"{_name} p={_p}"] = (
            PENCIL_WIDE["float" if "<float>" in _name else "double",
                        _p + 1 >= 15], KERNELS[_name][1])


# dg_kernel.kernel_digests on the card: the DG kernels' outputs on seeded
# inputs, as tests/test_torch_cuda.py pins them (DG_DIGESTS there); p =
# 10..16 recorded on an H100 from the kernels of dg_pencil_wide*.cu
DG_DIGESTS = {
    "p=1 hermite apply<double>": "cbe389b4cdc0a7ed",
    "p=1 hermite residual<double>": "da4b691d1a04e395",
    "p=1 hermite apply<float>": "fc0e5c679027ce7d",
    "p=1 hermite residual<float>": "6645ddf6dea3af39",
    "p=1 hermite cheb<float>": "ad0f187e19c42082",
    "p=1 hermite cheb<float> x=0": "96f695e52fdf41bc",
    "p=1 hermite dg_cg<double>": "7da9ebf46ce0cf63",
    "p=1 hermite dg_jacobi_cg<double>": "b758e6f723fbf287",
    "p=1 gll apply<double>": "c95fdb7d6858c591",
    "p=1 gll residual<double>": "3c4bc3f943c1dbc2",
    "p=1 gll apply<float>": "fc0e5c679027ce7d",
    "p=1 gll residual<float>": "6645ddf6dea3af39",
    "p=1 gll cheb<float>": "ad0f187e19c42082",
    "p=1 gll cheb<float> x=0": "96f695e52fdf41bc",
    "p=1 gll dg_cg<double>": "68cc75f274d47298",
    "p=1 gll dg_jacobi_cg<double>": "a12e94fafdfd9395",
    "p=1 gauss apply<double>": "e03b6e4844dca226",
    "p=1 gauss residual<double>": "62e2ae5a7607e0b3",
    "p=1 gauss apply<float>": "ca32dae2d76f75b3",
    "p=1 gauss residual<float>": "5492675a84b2ea84",
    "p=1 gauss cheb<float>": "7729b54e79e874d7",
    "p=1 gauss cheb<float> x=0": "c1397c116fd1966c",
    "p=1 gauss dg_cg<double>": "3dd5076b5f0300e0",
    "p=1 gauss dg_jacobi_cg<double>": "10078d98844cfa97",
    "p=2 hermite apply<double>": "d09ff99c96a14569",
    "p=2 hermite residual<double>": "63825632f01c7ce7",
    "p=2 hermite apply<float>": "891b98c7861cc3ea",
    "p=2 hermite residual<float>": "7bb339bfccc31f67",
    "p=2 hermite cheb<float>": "e6f8ac5ece895bbe",
    "p=2 hermite cheb<float> x=0": "d22d9987929d917d",
    "p=2 hermite dg_cg<double>": "e24384999fdbf29b",
    "p=2 hermite dg_jacobi_cg<double>": "a04ea0fa07b6306d",
    "p=2 gll apply<double>": "72717d49ab849d33",
    "p=2 gll residual<double>": "b6978377e14b6932",
    "p=2 gll apply<float>": "891b98c7861cc3ea",
    "p=2 gll residual<float>": "7bb339bfccc31f67",
    "p=2 gll cheb<float>": "e6f8ac5ece895bbe",
    "p=2 gll cheb<float> x=0": "d22d9987929d917d",
    "p=2 gll dg_cg<double>": "35a1203dd1b7467a",
    "p=2 gll dg_jacobi_cg<double>": "b81211b36e33daa4",
    "p=2 gauss apply<double>": "9c51abbeb30c05c2",
    "p=2 gauss residual<double>": "0bc8ac605cf39905",
    "p=2 gauss apply<float>": "2f61f96dcf6f6de4",
    "p=2 gauss residual<float>": "db5b828aabd51832",
    "p=2 gauss cheb<float>": "1d5e0617772c7fc6",
    "p=2 gauss cheb<float> x=0": "058df93cc5eaf45d",
    "p=2 gauss dg_cg<double>": "0a720ec4d79e03b5",
    "p=2 gauss dg_jacobi_cg<double>": "b3398e162df1c478",
    "p=3 hermite apply<double>": "ce2d98e8af3cb13f",
    "p=3 hermite residual<double>": "7088460b96f1b707",
    "p=3 hermite apply<float>": "237ba209fbdefcd3",
    "p=3 hermite residual<float>": "dbc82233eca41e2b",
    "p=3 hermite cheb<float>": "f8cf8010af033aa8",
    "p=3 hermite cheb<float> x=0": "754f23b44fe5621e",
    "p=3 hermite dg_cg<double>": "ee50a7cb2e1566ec",
    "p=3 hermite dg_jacobi_cg<double>": "d771abb08fb7784d",
    "p=3 gll apply<double>": "ae65adbae01d36d6",
    "p=3 gll residual<double>": "f26f87d8d419e42e",
    "p=3 gll apply<float>": "d944f2d2e5c657a7",
    "p=3 gll residual<float>": "4d4305c1410c861a",
    "p=3 gll cheb<float>": "891b7eb1ed43ed0f",
    "p=3 gll cheb<float> x=0": "f734087fa385d963",
    "p=3 gll dg_cg<double>": "0fae6c960bbcf68b",
    "p=3 gll dg_jacobi_cg<double>": "ab863e1c07f9be43",
    "p=3 gauss apply<double>": "873d0c370cc0819a",
    "p=3 gauss residual<double>": "7ef5fe5f7c1ce546",
    "p=3 gauss apply<float>": "f20b267f04f8c60b",
    "p=3 gauss residual<float>": "ce053714bbd35c13",
    "p=3 gauss cheb<float>": "cbd4bc3b1247643c",
    "p=3 gauss cheb<float> x=0": "fda9c8507067837e",
    "p=3 gauss dg_cg<double>": "84fce5a51fc83a8c",
    "p=3 gauss dg_jacobi_cg<double>": "0d95040563be1715",
    "p=4 hermite apply<double>": "0e96fdd52f153add",
    "p=4 hermite residual<double>": "7c9728365943135e",
    "p=4 hermite apply<float>": "5f4707c8ff24b944",
    "p=4 hermite residual<float>": "13b6e7186b0d6b60",
    "p=4 hermite cheb<float>": "0ebb556f8ebcfe59",
    "p=4 hermite cheb<float> x=0": "f1d0ef9c5bc1c864",
    "p=4 hermite dg_cg<double>": "2363cef068abf936",
    "p=4 hermite dg_jacobi_cg<double>": "3eb61a08c22e3b80",
    "p=4 gll apply<double>": "030c7fb02138d41c",
    "p=4 gll residual<double>": "3975663287b6fb6c",
    "p=4 gll apply<float>": "d2f57a890f62a8a4",
    "p=4 gll residual<float>": "1cca43797b5dabf6",
    "p=4 gll cheb<float>": "d3ce8099cf937248",
    "p=4 gll cheb<float> x=0": "e8cc25725a972e5b",
    "p=4 gll dg_cg<double>": "dd7283a8a26a4272",
    "p=4 gll dg_jacobi_cg<double>": "45a4bc1185280bc8",
    "p=4 gauss apply<double>": "a49d571b2030233b",
    "p=4 gauss residual<double>": "b4a5ea5a5c19219d",
    "p=4 gauss apply<float>": "59974179f8f05731",
    "p=4 gauss residual<float>": "524f658933362856",
    "p=4 gauss cheb<float>": "d1a376ba002b0028",
    "p=4 gauss cheb<float> x=0": "47d9f441840460e0",
    "p=4 gauss dg_cg<double>": "c9df4a3f821268c9",
    "p=4 gauss dg_jacobi_cg<double>": "27dda0cb9e430156",
    "p=5 hermite apply<double>": "d029de91ff84a443",
    "p=5 hermite residual<double>": "fe0982b7ca589267",
    "p=5 hermite apply<float>": "c233a387dbc0e0b0",
    "p=5 hermite residual<float>": "8ce4630333379677",
    "p=5 hermite cheb<float>": "6eb229bc5942ef51",
    "p=5 hermite cheb<float> x=0": "c3b0ecbd2ef0049a",
    "p=5 hermite dg_cg<double>": "e6a3c6c656fd0e86",
    "p=5 hermite dg_jacobi_cg<double>": "aba918e5a780e09d",
    "p=5 gll apply<double>": "6b2b8cf5f8516366",
    "p=5 gll residual<double>": "fdab6cc2645a044e",
    "p=5 gll apply<float>": "3c8f0790d0bbb5ed",
    "p=5 gll residual<float>": "1450e000e639baee",
    "p=5 gll cheb<float>": "87ef264744ebdabe",
    "p=5 gll cheb<float> x=0": "091a8244d7df4260",
    "p=5 gll dg_cg<double>": "9cd6f9695843f94d",
    "p=5 gll dg_jacobi_cg<double>": "a8fe63d7c73e6db5",
    "p=5 gauss apply<double>": "92fab143489e6ce9",
    "p=5 gauss residual<double>": "11809eab31d7116f",
    "p=5 gauss apply<float>": "25e2e3a3c60587b5",
    "p=5 gauss residual<float>": "5e405194cb22d812",
    "p=5 gauss cheb<float>": "1618d9dbdf289694",
    "p=5 gauss cheb<float> x=0": "b5ce8d4ddabf84b8",
    "p=5 gauss dg_cg<double>": "6dd2715fb8faf22c",
    "p=5 gauss dg_jacobi_cg<double>": "a71486b528b31e8c",
    "p=6 hermite apply<double>": "1353f657b9c2cadc",
    "p=6 hermite residual<double>": "7e0ee0e90f17249d",
    "p=6 hermite apply<float>": "7f87525a26e3348a",
    "p=6 hermite residual<float>": "92d5b25282b89b79",
    "p=6 hermite cheb<float>": "f6240e8ab5aabba5",
    "p=6 hermite cheb<float> x=0": "17c17b1be0fd3d6d",
    "p=6 hermite dg_cg<double>": "8d541bdcbb951b37",
    "p=6 hermite dg_jacobi_cg<double>": "51355a79173e3c7c",
    "p=6 gll apply<double>": "3da7114adf5908ce",
    "p=6 gll residual<double>": "5c89faf44000120d",
    "p=6 gll apply<float>": "474ab9b494c0aaec",
    "p=6 gll residual<float>": "962d276c19a64284",
    "p=6 gll cheb<float>": "023778461c72c198",
    "p=6 gll cheb<float> x=0": "4358fc677cecf2e1",
    "p=6 gll dg_cg<double>": "e78db1c354da2613",
    "p=6 gll dg_jacobi_cg<double>": "5837b6125e4bfdb8",
    "p=6 gauss apply<double>": "838b27fd2b88f550",
    "p=6 gauss residual<double>": "79617b2177635903",
    "p=6 gauss apply<float>": "8ba83d99256542ad",
    "p=6 gauss residual<float>": "5798efd2372943f6",
    "p=6 gauss cheb<float>": "1779680b1b3598ad",
    "p=6 gauss cheb<float> x=0": "63f1a1757c5c62e2",
    "p=6 gauss dg_cg<double>": "aa134388b920c8e5",
    "p=6 gauss dg_jacobi_cg<double>": "48204fe54a88f2e2",
    "p=7 hermite apply<double>": "0764e2cb4541e174",
    "p=7 hermite residual<double>": "bbb1e612c72e4e88",
    "p=7 hermite apply<float>": "b7a1b32c9e7fb936",
    "p=7 hermite residual<float>": "91d33e6f8d88d1d9",
    "p=7 hermite cheb<float>": "cd973aaa83d41627",
    "p=7 hermite cheb<float> x=0": "55d83a7c697b6407",
    "p=7 hermite dg_cg<double>": "72f3ad8cd4740f5e",
    "p=7 hermite dg_jacobi_cg<double>": "75b63723e03a438c",
    "p=7 gll apply<double>": "f892b438efd71463",
    "p=7 gll residual<double>": "26afbfc47c6b6331",
    "p=7 gll apply<float>": "96861381e8e5287b",
    "p=7 gll residual<float>": "dfc61af91185be91",
    "p=7 gll cheb<float>": "934c099b64fe9bf5",
    "p=7 gll cheb<float> x=0": "35ad4923ca607fba",
    "p=7 gll dg_cg<double>": "9233112feb9af1f8",
    "p=7 gll dg_jacobi_cg<double>": "5a923ea81b1acf8f",
    "p=7 gauss apply<double>": "cd5a95006490cd18",
    "p=7 gauss residual<double>": "c393f514197ce25c",
    "p=7 gauss apply<float>": "c4dc9e539b43ef06",
    "p=7 gauss residual<float>": "fe6066ff4ca75b6b",
    "p=7 gauss cheb<float>": "7338acd0e51bd948",
    "p=7 gauss cheb<float> x=0": "1b0944874bd4b325",
    "p=7 gauss dg_cg<double>": "ed30222af899b09c",
    "p=7 gauss dg_jacobi_cg<double>": "52b691fd32ed842a",
    "p=8 hermite apply<double>": "4ea424c4d3f2851e",
    "p=8 hermite residual<double>": "b6c0f4215fe2433b",
    "p=8 hermite apply<float>": "03708519182ade47",
    "p=8 hermite residual<float>": "53736ea5ba000b09",
    "p=8 hermite cheb<float>": "188010c7fcc243af",
    "p=8 hermite cheb<float> x=0": "2bf28804cdbf7cd4",
    "p=8 hermite dg_cg<double>": "f15e0f3e0d6c1346",
    "p=8 hermite dg_jacobi_cg<double>": "70d280729fcdab08",
    "p=8 gll apply<double>": "7f2bb7f5bddd19bf",
    "p=8 gll residual<double>": "1e06912ed8b63dec",
    "p=8 gll apply<float>": "28007f92af65b02f",
    "p=8 gll residual<float>": "7051aaaad9ed97ff",
    "p=8 gll cheb<float>": "e3da41069b599ad9",
    "p=8 gll cheb<float> x=0": "2622d76840911ee9",
    "p=8 gll dg_cg<double>": "65e2aa84aec71dfc",
    "p=8 gll dg_jacobi_cg<double>": "4da2c4f6750e5e83",
    "p=8 gauss apply<double>": "1ac2c71b96454028",
    "p=8 gauss residual<double>": "77568340ab6710e2",
    "p=8 gauss apply<float>": "808ed210c6e8fbf4",
    "p=8 gauss residual<float>": "f55d88c6e1c90813",
    "p=8 gauss cheb<float>": "870f95215e4e550f",
    "p=8 gauss cheb<float> x=0": "22a78c0d3c39b2a0",
    "p=8 gauss dg_cg<double>": "3ed9cd5f1ee393e5",
    "p=8 gauss dg_jacobi_cg<double>": "c0fc1d1ef768601c",
    "p=9 hermite apply<double>": "02756c82dbfa4eac",
    "p=9 hermite residual<double>": "131d8914eb231026",
    "p=9 hermite apply<float>": "85dcdf20411ded86",
    "p=9 hermite residual<float>": "933b2cd06cd5f353",
    "p=9 hermite cheb<float>": "81e79bddfc96c891",
    "p=9 hermite cheb<float> x=0": "59af851d163eedc1",
    "p=9 hermite dg_cg<double>": "0bf8e631f8161e4d",
    "p=9 hermite dg_jacobi_cg<double>": "6fc7f0d3684c5a49",
    "p=9 gll apply<double>": "6464c083ae83fe3b",
    "p=9 gll residual<double>": "80625610349f4374",
    "p=9 gll apply<float>": "1a481eaf62c7d178",
    "p=9 gll residual<float>": "1d83e39a11e08145",
    "p=9 gll cheb<float>": "63179bf30e3f234c",
    "p=9 gll cheb<float> x=0": "5cfbffc09335ac90",
    "p=9 gll dg_cg<double>": "3b7c50eb7b56f60d",
    "p=9 gll dg_jacobi_cg<double>": "81ba547bda4690fe",
    "p=9 gauss apply<double>": "5bd51644b8aabf08",
    "p=9 gauss residual<double>": "0452855dd6afab1f",
    "p=9 gauss apply<float>": "c55309fd03ddb48a",
    "p=9 gauss residual<float>": "857d96a8f37ff2bd",
    "p=9 gauss cheb<float>": "379fe76fdb880742",
    "p=9 gauss cheb<float> x=0": "e90b1107b710eccb",
    "p=9 gauss dg_cg<double>": "b1632f9637f082ea",
    "p=9 gauss dg_jacobi_cg<double>": "b9713fbf9d85db0f",
    "p=10 hermite apply<double>": "40c73de9938d2657",
    "p=10 hermite residual<double>": "052354a6fe498c36",
    "p=10 hermite apply<float>": "43b003e6b19af53f",
    "p=10 hermite residual<float>": "130e342b140ed540",
    "p=10 hermite cheb<float>": "1d1ed3dea73c9f0c",
    "p=10 hermite cheb<float> x=0": "4c4f17a95b82bc67",
    "p=10 gll apply<double>": "17eb8a3a6e5c4ef1",
    "p=10 gll residual<double>": "416610a675c2717d",
    "p=10 gll apply<float>": "5914f39f24b4d072",
    "p=10 gll residual<float>": "c885d3b2766acf97",
    "p=10 gll cheb<float>": "226b8feef5d901f0",
    "p=10 gll cheb<float> x=0": "d3fbb9ea2bc7c3bb",
    "p=10 gauss apply<double>": "663de14476d8a573",
    "p=10 gauss residual<double>": "90b978e439f4f387",
    "p=10 gauss apply<float>": "71554e064d9973c0",
    "p=10 gauss residual<float>": "9dedf515f0c21bff",
    "p=10 gauss cheb<float>": "8e680c95ebddc741",
    "p=10 gauss cheb<float> x=0": "ef1b3b11f9aea004",
    "p=11 hermite apply<double>": "042aa817331db0b2",
    "p=11 hermite residual<double>": "b81ba66e755dea67",
    "p=11 hermite apply<float>": "4b6d7adeacdabd28",
    "p=11 hermite residual<float>": "df1fc9a0a95ba1d2",
    "p=11 hermite cheb<float>": "d02d90b28b5f6614",
    "p=11 hermite cheb<float> x=0": "151446fd97a208ce",
    "p=11 gll apply<double>": "41576f260eb57b24",
    "p=11 gll residual<double>": "8b3da8affbd52489",
    "p=11 gll apply<float>": "a70d8cf810b1a7a0",
    "p=11 gll residual<float>": "614018514e31e7f1",
    "p=11 gll cheb<float>": "c7ff01b13ca7f117",
    "p=11 gll cheb<float> x=0": "c7f1a2e63df26eaa",
    "p=11 gauss apply<double>": "b4b86b566ea4c580",
    "p=11 gauss residual<double>": "d950eb32a3ef190c",
    "p=11 gauss apply<float>": "3a78c9263b062156",
    "p=11 gauss residual<float>": "83c7c437d95b5d32",
    "p=11 gauss cheb<float>": "e1534f17c1ce813e",
    "p=11 gauss cheb<float> x=0": "55d51302e7aeea69",
    "p=12 hermite apply<double>": "1f3aede5686aa2e6",
    "p=12 hermite residual<double>": "f7e21585c38e3b5a",
    "p=12 hermite apply<float>": "808cc289093e74ac",
    "p=12 hermite residual<float>": "fc7585a8d5c5df74",
    "p=12 hermite cheb<float>": "34387cffebc359af",
    "p=12 hermite cheb<float> x=0": "a57554b6faafe25b",
    "p=12 gll apply<double>": "6a173b636ada7048",
    "p=12 gll residual<double>": "842b30ea50d27a6c",
    "p=12 gll apply<float>": "21650ff1e438353b",
    "p=12 gll residual<float>": "26b4aa84424a8b3d",
    "p=12 gll cheb<float>": "a0a4b9fd66b9169e",
    "p=12 gll cheb<float> x=0": "354a6298fa647e6c",
    "p=12 gauss apply<double>": "06846a9069aa2b92",
    "p=12 gauss residual<double>": "a6c82927a4845bba",
    "p=12 gauss apply<float>": "0c220fdf53a87eb9",
    "p=12 gauss residual<float>": "1075a1d7076c10f7",
    "p=12 gauss cheb<float>": "dfdf2d10113973b6",
    "p=12 gauss cheb<float> x=0": "967c07bcbc22bd7d",
    "p=13 hermite apply<double>": "d4c60878efe4d4ea",
    "p=13 hermite residual<double>": "5d16924c1f7abb3c",
    "p=13 hermite apply<float>": "672f9b5b09c84eb2",
    "p=13 hermite residual<float>": "c7af6f903c1523d8",
    "p=13 hermite cheb<float>": "f6a53c01315c81ac",
    "p=13 hermite cheb<float> x=0": "e0682a68b5bcd96d",
    "p=13 gll apply<double>": "c2642f18d77f429d",
    "p=13 gll residual<double>": "cb4233b29e137575",
    "p=13 gll apply<float>": "17d38c91acbf39fd",
    "p=13 gll residual<float>": "5f7032fa255719e3",
    "p=13 gll cheb<float>": "a82ec8f775eb7507",
    "p=13 gll cheb<float> x=0": "f3a195ba2c3e7bca",
    "p=13 gauss apply<double>": "1a70cbad1be52cbc",
    "p=13 gauss residual<double>": "b774d7632a188f1f",
    "p=13 gauss apply<float>": "a9952633218cacdd",
    "p=13 gauss residual<float>": "9c495f4b884eb6ba",
    "p=13 gauss cheb<float>": "be0ca71964ea2993",
    "p=13 gauss cheb<float> x=0": "5c26d589e3e83aa5",
    "p=14 hermite apply<double>": "66387039f3002232",
    "p=14 hermite residual<double>": "3c552197c0049bd7",
    "p=14 hermite apply<float>": "90a27a68f51de87f",
    "p=14 hermite residual<float>": "e236f8a840729f89",
    "p=14 hermite cheb<float>": "3dcbaa4977ef3b40",
    "p=14 hermite cheb<float> x=0": "28d6aba5cf2ea174",
    "p=14 gll apply<double>": "a57cd03a715972cc",
    "p=14 gll residual<double>": "5c11642d706e953c",
    "p=14 gll apply<float>": "9df4bae875c66ff1",
    "p=14 gll residual<float>": "fad7327bee9c3393",
    "p=14 gll cheb<float>": "c2386a53c694bbbe",
    "p=14 gll cheb<float> x=0": "b3d37fe61b186bad",
    "p=14 gauss apply<double>": "910bae73965fe6ee",
    "p=14 gauss residual<double>": "4e53a8ee667f1c65",
    "p=14 gauss apply<float>": "24d3490ae7e63bb5",
    "p=14 gauss residual<float>": "0b08de200f00da65",
    "p=14 gauss cheb<float>": "c5602b6290af22ae",
    "p=14 gauss cheb<float> x=0": "0e89c8c6a38cde89",
    "p=15 hermite apply<double>": "28fcc11d8a21ad98",
    "p=15 hermite residual<double>": "164dd56516e736b6",
    "p=15 hermite apply<float>": "918d423fd6a2c3ff",
    "p=15 hermite residual<float>": "66b62c9b862d586a",
    "p=15 hermite cheb<float>": "7f16fa2802375229",
    "p=15 hermite cheb<float> x=0": "759125629cafe4f0",
    "p=15 gll apply<double>": "f23026788a28cdf5",
    "p=15 gll residual<double>": "e3f4022595c7a1ec",
    "p=15 gll apply<float>": "86ee5ddf5f51caaa",
    "p=15 gll residual<float>": "d234b7b9a6a86216",
    "p=15 gll cheb<float>": "9a53fe6c062c3116",
    "p=15 gll cheb<float> x=0": "e29fee20721b2df9",
    "p=15 gauss apply<double>": "9b9738a7b74966c9",
    "p=15 gauss residual<double>": "9744f6c99c098074",
    "p=15 gauss apply<float>": "e07df9dd191b63e5",
    "p=15 gauss residual<float>": "bf98b374dd30ab2d",
    "p=15 gauss cheb<float>": "5d8b1e195c791d0e",
    "p=15 gauss cheb<float> x=0": "2296b880c7415e5a",
    "p=16 hermite apply<double>": "8e1aa105a52999b5",
    "p=16 hermite residual<double>": "09917587da2bd00a",
    "p=16 hermite apply<float>": "3783ba59306c7f04",
    "p=16 hermite residual<float>": "f7362036a2d44df7",
    "p=16 hermite cheb<float>": "160abfbb46ab8342",
    "p=16 hermite cheb<float> x=0": "453d059ccf081a88",
    "p=16 gll apply<double>": "7ea88fbed9719837",
    "p=16 gll residual<double>": "966dbced62633051",
    "p=16 gll apply<float>": "6752710526fd83de",
    "p=16 gll residual<float>": "f8d969843bf597e6",
    "p=16 gll cheb<float>": "42662889f4fd542a",
    "p=16 gll cheb<float> x=0": "a2bf267cfaeb4cbe",
    "p=16 gauss apply<double>": "7cd14a14b8030702",
    "p=16 gauss residual<double>": "fca166673cf86ea2",
    "p=16 gauss apply<float>": "a609d1486f6d2b89",
    "p=16 gauss residual<float>": "058818b5c242a03c",
    "p=16 gauss cheb<float>": "7f753442357f8fee",
    "p=16 gauss cheb<float> x=0": "dcf06f4b2be243f4",
}

# brick_kron at p = 10..16 on seeded inputs (x seed 1, b 2, x_old 3, f1 =
# 0.37, f2 = 0.81): sha256 (first 16 hex digits) of each mode's output,
# recorded on an H100 from the z-slab march of brick_kron_wide*.cu, as
# tests/test_torch_cuda.py pins them (KRON_WIDE_DIGESTS there); case ->
# (cells, p) of ``brick``
KRON_WIDE_CASES = {"cube2_p10": ((2, 2, 2), 10),
                   "one_cell_axis_p16": ((1, 3, 2), 16),
                   "tiles_p10": ((3, 4, 7), 10), "tiles_p11": ((2, 3, 5), 11),
                   "ragged_p13": ((3, 2, 4), 13), "cube2_p16": ((2, 2, 2), 16)}
KRON_WIDE_DIGESTS = {
    "cube2_p10 float apply": "d18bfeffe84b9d1a",
    "cube2_p10 float vmult": "d38a0dc276f38469",
    "cube2_p10 float residual": "512e7977d6cc7693",
    "cube2_p10 float cheb": "4c17401b23586f49",
    "cube2_p10 double apply": "10980282e66a3dd3",
    "cube2_p10 double vmult": "25f2fcc6853a1f36",
    "cube2_p10 double residual": "f2db088aa0b3bf5f",
    "cube2_p10 double cheb": "f42cffda6d16cac0",
    "one_cell_axis_p16 float apply": "138c913cd63a8382",
    "one_cell_axis_p16 float vmult": "d2b9da31b361668a",
    "one_cell_axis_p16 float residual": "8f571344ac399681",
    "one_cell_axis_p16 float cheb": "ca24f68401914190",
    "one_cell_axis_p16 double apply": "97a802e2d406a516",
    "one_cell_axis_p16 double vmult": "9eedc5cdd2a880e0",
    "one_cell_axis_p16 double residual": "fee2c8d1d1372dc3",
    "one_cell_axis_p16 double cheb": "84cdd9a2a336aff8",
    "tiles_p10 float apply": "d6aea056670b3d29",
    "tiles_p10 float vmult": "be21f2869a66e4e2",
    "tiles_p10 float residual": "8e7b8d24b6004288",
    "tiles_p10 float cheb": "5b731a94a904b646",
    "tiles_p10 double apply": "1dc9460d044683fe",
    "tiles_p10 double vmult": "7ba25dc59ac330d5",
    "tiles_p10 double residual": "f08b243f52a1f525",
    "tiles_p10 double cheb": "a18cb5ca964d65b3",
    "tiles_p11 float apply": "e39f6c5487c55e86",
    "tiles_p11 float vmult": "9eada12b52c482a6",
    "tiles_p11 float residual": "2c9e9b701d6904d0",
    "tiles_p11 float cheb": "5f05570099aad7c2",
    "tiles_p11 double apply": "0afa41516346ef1a",
    "tiles_p11 double vmult": "87d883286efced23",
    "tiles_p11 double residual": "069e6eadf124c17a",
    "tiles_p11 double cheb": "997352cdfe032088",
    "ragged_p13 float apply": "e015aebef2a9621b",
    "ragged_p13 float vmult": "2ce4fb7e74617230",
    "ragged_p13 float residual": "7f2b645f981ef7cb",
    "ragged_p13 float cheb": "a0c110b9d8422a62",
    "ragged_p13 double apply": "467e1849979d1c82",
    "ragged_p13 double vmult": "b809a8a7d39947f4",
    "ragged_p13 double residual": "4ba7a64d47ff9848",
    "ragged_p13 double cheb": "ea13f8925f52e873",
    "cube2_p16 float apply": "20bebad61efe7f00",
    "cube2_p16 float vmult": "07e43775960eea5b",
    "cube2_p16 float residual": "416aee5be43202ad",
    "cube2_p16 float cheb": "8c40de7d5e554446",
    "cube2_p16 double apply": "a6084f199c059e71",
    "cube2_p16 double vmult": "36eb337778eb49e8",
    "cube2_p16 double residual": "f2448168aad5a24f",
    "cube2_p16 double cheb": "ec3a9ea5220fe916",
}


def degree_path(p: int, path: str = "poisson_cube") -> str:
    return f"{path}_p{p}"


def path_degree(path: str):
    """The degree of a path named by :func:`degree_path`, else None."""
    head, _, deg = path.rpartition("_p")
    return int(deg) if head and deg.isdigit() else None


# kernels each path must launch (brick_kron_cheb<double> and
# cheb_epilogue<double> are on no path: checked and timed only)
CUBE_KERNELS = ["brick_kron<double>", "brick_kron<float>",
                "brick_kron_cheb<float>", "cheb_epilogue<float>",
                "cg_update", "cg_dot", "cg_xpay"]
DG_KERNELS = ["dg_apply<double>", "dg_apply<float>", "dg_cheb<float>",
              "brick_kron<float>", "brick_kron_cheb<float>",
              "cheb_epilogue<float>", "cg_update", "cg_dot", "cg_xpay"]
DG_PLAIN_KERNELS = ["dg_apply<double>", "dg_apply<float>", "dg_cheb<float>",
                    "cg_update", "cg_dot", "cg_xpay"]
SHELL_KERNELS = ["cg_update", "cg_dot", "cg_xpay"]
# solver_dg: the fused row's kernels, the unfused row's A p and CG kernels
SOLVER_DG_KERNELS = ["dg_cg<double>", "dg_jacobi_cg<double>",
                     "dg_apply<double>", "cg_update", "cg_dot", "cg_xpay"]
# the curved DG, poisson_l and 2-D paths: no others
CG_KERNELS = SHELL_KERNELS
# the paths that run no brick or DG kernel (plain levels, CG kernels)
PLAIN_PATHS = ("poisson_shell", "poisson_dg_plain_curved", "poisson_l",
               "poisson_dg_plain_2d", "poisson_cube_2d", "poisson_dg_2d",
               "poisson_dg_ranks_2d")

# the curved DG-plain path (poisson_dg_plain --deform 0.05, hermite, n_pre
# 3): its rows at 512 and 4096 DG dofs, p = 3, rtol 1e-10 -- the JAX
# driver's on the CPU, kind -> ((frac its, L2) per size) -- held on the card
# against the port on the CPU and against these: iterations within one,
# frac its and L2 to 1%
CURVED_FACTOR = 0.05
CURVED_ANCHORS = {
    "hermite": ((11.3659, 1.5964e-1), (11.1031, 1.0396e-1)),
    "gll": ((10.8137, 1.5964e-1), (10.8945, 1.0396e-1)),
    "gauss": ((10.4466, 1.5964e-1), (11.1137, 1.0396e-1)),
}
CURVED_AGREE = 0.01
# the large row: hermite p = 4 at size 24 (1,728,000 DG dofs, four levels;
# size 48 spent 81 s in set-up on one H100, near a sixth of the script),
# rtol 1e-9, rate below the bar of tests/test_dg_curved.py:150-174, frac
# its within one of the first card run's at this size (10.1254; 9.9819 at
# size 48), L2 the affine DG-plain row's of the same run (size 48) to
# CURVED_L2_AGREE (the Dirichlet plateau: 4.5e-7 apart on that first run)
CURVED_SIZE = 24
CURVED_RATE = 0.35
CURVED_ITS = 10.13
CURVED_L2_AGREE = 1e-5
CURVED_SETUP_LIMIT = 150.0
# poisson_l (2-D, FE_Q(2), global coarsening, rtol 1e-9): the first four
# cycles of --initial 5 (the JAX driver's rows on the CPU: dofs,
# constraints, its, reduction, val_L2), run on the card and on the CPU on
# the card's forest each cycle (iterations within one, val_L2 to 1%) and,
# while the card's meshes are the JAX driver's, against these (dofs and
# constraints exact, iterations within one, reduction and val_L2 to 1%);
# the top rows from --initial 7 until one passes L_TOP_DOFS, below
# poisson_l's --max-dofs ceiling L_MAX_DOFS, each row's (iterations,
# reduction) those of the port on the CPU (197,633 dofs; the rows from
# --initial 8, 788,481 dofs at 8 its and 0.06933 on the card, then
# 1,121,717 at 8 and 0.06912, were cut to keep the script near half its
# time limit): iterations within one, reduction to L_TOP_AGREE;
# one --dim 3 --initial 3 cycle pair; one --local-smoothing row at
# --initial 7 (197,633 dofs)
L_ANCHORS = [(12545, 0, 8, 0.06868, 1.1102e-4),
             (17865, 288, 8, 0.06927, 4.3601e-5),
             (24975, 1632, 8, 0.06922, 1.7189e-5),
             (35161, 3764, 8, 0.06910, 6.7952e-6)]
L_AGREE = 0.01
L_TOP_INITIAL, L_TOP_DOFS, L_MAX_DOFS = 7, 190_000, 2_000_000
L_TOP_ROWS = [(8, 0.06889)]
L_TOP_AGREE = 0.03
L_ITS = 10              # the bar of tests/test_adaptive.py on every row
L_LOCAL_INITIAL, L_LOCAL_DOFS = 7, 197_633


# the rank path: launches of (ranks, rank grid, runs of (dim, cube size))
# on gloo sharing the card; the CG solution against the single-device one
# of this run
RANKS_RUNS = ((2, (2,), ((3, MEM_SIZE),)),
              (4, (2, 2), ((3, SIZE), (2, CUBE2_SIZE))))
RANKS_SOL_BAR = 1e-7       # of max|u|
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"
# the DG rank path: launches of (ranks, rank grid, runs of (solver, size,
# kind)) on gloo sharing the card, p = 4, n_pre 3
# (``experiments/time_ranks.py``'s DG rows), each against its one-device
# row of this run (DG-over-CG on 2 x 2 at size 32: every FE_Q level above
# the coarsest two splits); the 2 x 2 launch also runs HaloDGLaplace2D at
# DG_RANKS_2D^3 cells; one nccl rank of each solver at DG_RANKS_SINGLE
DG_RANKS_RUNS = ((2, (2,), (("dg", 64, "hermite"),)),
                 (4, (2, 2), (("dg-plain", DG_SIZE, "gauss"),
                              ("dg", 32, "hermite"))))
DG_RANKS_2D = DG_SIZE
# the 2-D DG rows on ranks, in both launches of DG_RANKS_RUNS: (solver,
# size, degree, kind) of the one-device 2-D rows of this run (the top
# DG-plain row, p = 3, 4,194,304 DG dofs; the DG row, p = 4, 2,560,000),
# each held against that row; the exchange split on DG2_RANKS_COMM reps
DG2_RANKS_RUNS = (("dg-plain", DG2_LARGE[-1], DG2_DEGREE, "hermite"),
                  ("dg", DG2D_SIZE, 4, "hermite"))
DG2_RANKS_COMM = 5
DG_RANKS_SINGLE = 24
NCCL_DG = (("dg", "hermite"), ("dg-plain", "gauss"))
DG_HERMITE_BAR = 1e-12     # of max|y|, f64: the hermite wire's owned cells


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes`` through HBM and doing
    ``flops`` at the peak rate of ``dtype``, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one call, from CUDA events over ``reps`` calls."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


class KernelChecks:
    """Kernel-vs-plain comparisons; keeps the worst error per kernel."""

    def __init__(self, dev):
        self.dev = dev
        self.err = {k: 0.0 for k in KERNELS}
        self.rel = {k: 0.0 for k in KERNELS}   # err / the scale of its bar
        self.ms = {}
        self.plain_ms = {}
        self.bound = {}                      # name -> (ms, "bytes"/"operations")
        self.library_ms = {k: None for k in KERNELS}
        self.residual = {}                   # residual modes, by name

    def note(self, name, got, want, scale, tol):
        err = float((got - want).abs().max())
        self.err[name] = max(self.err[name], err)
        self.rel[name] = max(self.rel[name], err / scale)
        require(err <= tol * scale,
                f"{name}: max|err| {err:.3e} > {tol:g} * {scale:.3e}")

    def rand(self, shape, dtype, seed):
        a = np.random.default_rng(seed).standard_normal(shape)
        return torch.as_tensor(a, dtype=dtype, device=self.dev)

    def operator_checks(self, grid, timed: bool):
        """cheb_epilogue on a given y: in double the residual at
        1e-14·max|out| (on no path), in float the Chebyshev update (the
        x = 0 step's kernel) at 3e-6·max|out|; then brick_kron in both
        dtypes (:meth:`kron_checks`)."""
        from multigrid_tpu_torch.ops import laplace_kernel as lk

        f32, f64 = torch.float32, torch.float64
        op = lk.BrickLaplace(grid, f64, self.dev)
        x = self.rand(grid.shape, f64, 1)
        y_ref = lk.brick_apply_plain(x, op.K)
        b = self.rand(grid.shape, f64, 2)
        args = dict(x=x, residual_only=True)
        got = lk.cheb_epilogue(b, y_ref, **args)
        want = lk.cheb_epilogue_plain(b, y_ref, **args)
        self.note("cheb_epilogue<double>", got, want, float(want.abs().max()),
                  1e-14)
        op32 = lk.BrickLaplace(grid, f32, self.dev)
        x32, b32, xo32, y32 = (t.float() for t in (x, b, self.rand(
            grid.shape, f64, 3), y_ref))
        args32 = dict(x=x32, x_old=xo32, lines=op32.lines, f1=0.37, f2=0.81)
        got = lk.cheb_epilogue(b32, y32, **args32)
        want = lk.cheb_epilogue_plain(b32, y32, **args32)
        self.note("cheb_epilogue<float>", got, want, float(want.abs().max()),
                  3e-6)
        if timed:
            nodes = grid.n_dofs
            self.ms["cheb_epilogue<double>"] = time_ms(
                lambda: lk.cheb_epilogue(b, y_ref, **args))
            self.plain_ms["cheb_epilogue<double>"] = time_ms(
                lambda: lk.cheb_epilogue_plain(b, y_ref, **args))
            self.ms["cheb_epilogue<float>"] = time_ms(
                lambda: lk.cheb_epilogue(b32, y32, **args32))
            self.plain_ms["cheb_epilogue<float>"] = time_ms(
                lambda: lk.cheb_epilogue_plain(b32, y32, **args32))
            # b, y in, out (f64 residual); b, y, x, x_old in, out (f32
            # update, ~15 flops a node)
            self.bound["cheb_epilogue<double>"] = bound(3 * 8 * nodes,
                                                        nodes, f64)
            self.bound["cheb_epilogue<float>"] = bound(5 * 4 * nodes,
                                                       15 * nodes, f32)
        del op, x, y_ref, b, got, want
        for dtype in (f32, f64):
            self.kron_checks(grid, timed, dtype)

    def kron_checks(self, grid, timed: bool, dtype, seed: int = 4,
                    label: str = ""):
        """brick_kron in ``dtype`` against the dense plain path in f64 on
        the same inputs, at the bars of KRON_BARS: apply on random x and
        vmult at the bar of max|y|; residual at the bar of max|A x| and the
        Chebyshev step at its bar of max|out| on the smoother's iterates
        (random b, x = D^-1 z, x_old = D^-1 z'), with x_old, with x_old =
        None and in place into x_old (bit for bit); one launch a call, a
        repeated apply bit for bit.  Timed: the kernel, and its plain
        version in ``dtype``.  The numbers go under the kernel's name plus
        ``label`` (" p=8": the entries of the degree-8 kernels)."""
        from multigrid_tpu_torch.ops import laplace_kernel as lk

        cname, tol, tol_cheb = KRON_BARS[dtype]
        base = f"brick_kron<{cname}>"
        name, cheb = base + label, f"brick_kron_cheb<{cname}>{label}"
        op, op64 = (lk.BrickLaplace(grid, t, self.dev)
                    for t in (dtype, torch.float64))
        x = self.rand(grid.shape, dtype, seed)
        y = lk.brick_apply_plain(x.double(), op64.K)
        scale = float(y.abs().max())
        before = lk.LAUNCHES[base]
        first = lk.brick_kron(x, op, "apply")
        require(lk.LAUNCHES[base] - before == 1, f"{name}: not one launch")
        self.note(name, first.double(), y, scale, tol)
        require(torch.equal(first, lk.brick_kron(x, op, "apply")),
                f"{name}: a repeated apply differs")
        self.note(name, lk.brick_kron(x, op, "vmult").double(),
                  torch.where(op64.interior, y, x.double()),
                  max(scale, float(x.abs().max())), tol)
        b, xc, xo = lk.smoother_iterates(op64, seed)
        bt, xct, xot = (t.to(dtype) for t in (b, xc, xo))
        y = lk.brick_apply_plain(xc, op64.K)
        want = lk.cheb_epilogue_plain(b, y, x=xc, residual_only=True)
        self.note(name, lk.brick_kron(xct, op, "residual", b=bt).double(),
                  want, float(y.abs().max()), tol)
        f1, f2 = 0.37, 0.81
        for xold, xoldt in ((xo, xot), (None, None)):
            want = lk.cheb_epilogue_plain(b, y, xc, xold, op64.lines, f1, f2)
            got = lk.brick_kron(xct, op, "cheb", b=bt, x_old=xoldt, f1=f1,
                                f2=f2)
            self.note(cheb, got.double(), want, float(want.abs().max()),
                      tol_cheb)
        alias = xot.clone()
        lk.brick_kron(xct, op, "cheb", b=bt, x_old=alias, f1=f1, f2=f2,
                      out=alias)
        require(torch.equal(alias, lk.brick_kron(xct, op, "cheb", b=bt,
                                                 x_old=xot, f1=f1, f2=f2)),
                f"{cheb}: in place into x_old differs")
        del op64, y, want, got, b, xc, xo
        if not timed:
            return
        K = op.K
        self.ms[name] = time_ms(lambda: lk.brick_kron(x, op))
        self.plain_ms[name] = time_ms(lambda: lk.brick_apply_plain(x, K))
        self.ms[cheb] = time_ms(
            lambda: lk.brick_kron(xct, op, "cheb", b=bt, x_old=xot, f1=f1,
                                  f2=f2))
        self.plain_ms[cheb] = time_ms(
            lambda: lk.cheb_epilogue_plain(bt, lk.brick_apply_plain(xct, K),
                                           xct, xot, op.lines, f1, f2))
        # bytes: x in, y out (apply); x, b in, out (residual); x, x_old, b
        # in, out (cheb).  Flops: seven banded sweeps of p + 2 taps on
        # average a node, plus the epilogue
        nodes, p, size = grid.n_dofs, grid.degree, x.element_size()
        flops = 14 * (p + 2) * nodes
        self.bound[name] = bound(2 * size * nodes, flops, dtype)
        self.bound[cheb] = bound(4 * size * nodes, flops + 10 * nodes, dtype)
        self.residual[name] = dict(
            ms=time_ms(lambda: lk.brick_kron(xct, op, "residual", b=bt)),
            plain_ms=time_ms(lambda: lk.cheb_epilogue_plain(
                bt, lk.brick_apply_plain(xct, K), x=xct,
                residual_only=True)),
            bound=bound(3 * size * nodes, flops + nodes, dtype))

    def layer_checks(self, grid, label: str):
        """The layer march (``brick_form``'s float form on ``grid``) in its
        four modes against ``brick_kron_reference`` (the plain separable
        version, float) on the same inputs at the bars of KRON_BARS, and
        against the z-slab march (the form these grids had before) bit
        for bit; the march's step and apply timed beside (printed, under
        no kernel).  The errors go under the float entries of ``label``."""
        from multigrid_tpu_torch.ops import laplace_kernel as lk

        f32 = torch.float32
        _, tol, tol_cheb = KRON_BARS[f32]
        p = grid.degree
        require(lk.brick_form(grid.shape, p, f32) == "layer",
                f"p={p} {grid.shape}: the float form is not the layer march")
        op = lk.BrickLaplace(grid, f32, self.dev)
        b, x, xo = lk.smoother_iterates(lk.BrickLaplace(
            grid, torch.float64, self.dev), 7)
        b, x, xo = b.float(), x.float(), xo.float()
        args = dict(b=b, x_old=xo, f1=0.37, f2=0.81)
        auto = lk.brick_form

        def march(mode):
            lk.brick_form = lambda shape, q, dtype: "march"
            try:
                return lk.brick_kron(x, op, mode, **args)
            finally:
                lk.brick_form = auto
        for mode in lk.KRON_MODES:
            name = (f"brick_kron_cheb<float>{label}" if mode == "cheb"
                    else f"brick_kron<float>{label}")
            got = lk.brick_kron(x, op, mode, **args)
            want = lk.brick_kron_reference(x, op, mode, **args)
            self.note(name, got.double(), want.double(),
                      float(want.abs().max()),
                      tol_cheb if mode == "cheb" else tol)
            require(torch.equal(got, march(mode)),
                    f"{name} {mode}: the layer march differs from the "
                    "z-slab march")
        ms = {mode: time_ms(lambda: march(mode)) for mode in ("apply", "cheb")}
        print(f"  layer march p={p} {grid.shape}: four modes within the "
              f"bars of brick_kron_reference, bit for bit the z-slab "
              f"march's; the z-slab march apply {ms['apply']:.4f} ms, step "
              f"{ms['cheb']:.4f} ms")

    def cg_checks(self, n: int, timed: bool):
        from multigrid_tpu_torch.ops import cg_kernel as ck

        f64 = torch.float64
        x, r, p, q, z = (self.rand((n,), f64, s) for s in range(10, 15))
        alpha, beta = 0.7234912384001122, 0.3141592653589793
        x1, r1 = x.clone(), r.clone()
        rr = ck.cg_update(x1, r1, p, q, alpha)
        x2, r2 = x.clone(), r.clone()
        rr_ref = ck.cg_update_plain(x2, r2, p, q, alpha)
        self.note("cg_update", x1, x2, float(x2.abs().max()), 1e-14)
        self.note("cg_update", r1, r2, float(r2.abs().max()), 1e-14)
        self.note("cg_update", rr, rr_ref, float(rr_ref), 1e-14)
        p1, p2 = p.clone(), p.clone()
        ck.cg_xpay(p1, z, beta)
        ck.cg_xpay_plain(p2, z, beta)
        self.note("cg_xpay", p1, p2, float(p2.abs().max()), 1e-14)
        # views off a 16-byte boundary: p and z of one phase, and of two
        for zv in (z[1:], z[:-1]):
            pv, pw = p.clone()[1:], p.clone()[1:]
            ck.cg_xpay(pv, zv, beta)
            ck.cg_xpay_plain(pw, zv, beta)
            self.note("cg_xpay", pv, pw, float(pw.abs().max()), 1e-14)
        d = ck.cg_dot(r, z)
        d_ref = ck.cg_dot_plain(r, z)
        self.note("cg_dot", d, d_ref, float((r * z).abs().sum()), 1e-14)
        if timed:
            a = 1e-3
            self.ms["cg_update"] = time_ms(lambda: ck.cg_update(x1, r1, p, q, a))
            self.plain_ms["cg_update"] = time_ms(
                lambda: ck.cg_update_plain(x2, r2, p, q, a))
            self.ms["cg_dot"] = time_ms(lambda: ck.cg_dot(r, z))
            self.plain_ms["cg_dot"] = time_ms(lambda: ck.cg_dot_plain(r, z))
            self.ms["cg_xpay"] = time_ms(lambda: ck.cg_xpay(p1, z, 1e-3))
            self.plain_ms["cg_xpay"] = time_ms(
                lambda: ck.cg_xpay_plain(p2, z, 1e-3))
            # one PyTorch call computing the same function, where one exists
            self.library_ms["cg_dot"] = time_ms(lambda: torch.dot(r, z))
            self.library_ms["cg_xpay"] = time_ms(
                lambda: torch.add(z, p2, alpha=1e-3))
            # bytes: x, r, p, q in, x, r out; a, b in; p, z in, p out
            for name, streams, flops in (("cg_update", 6, 6), ("cg_dot", 2, 2),
                                         ("cg_xpay", 3, 2)):
                self.bound[name] = bound(streams * 8 * n, flops * n, f64)

    def cheb_checks(self, ops, face: bool, seed: int = 22, label: str = ""):
        """dg_cheb<float> on the smoother's iterates against the plain f64
        step (and, if ``face``, the step with A from the face-based
        operator): with x and x_old, without x, without x_old at
        1e-5·max|out|, with f2 = 0 at 1e-6·max|x|; in place into x_old bit
        for bit.  The errors go under the kernel's name plus ``label``.
        Returns the float32 (b, x, x_old)."""
        import types

        from multigrid_tpu_torch.ops import dg_kernel as dk
        from multigrid_tpu_torch.ops.dg_face import DGLaplaceFaceBased

        f32, f64 = torch.float32, torch.float64
        refs = [ops[f64]]
        if face:
            refs.append(types.SimpleNamespace(
                plain=DGLaplaceFaceBased(ops[f64].grid, f64, self.dev),
                jacobi=ops[f64].jacobi))
        b, xc, xo = dk.smoother_iterates(ops[f64].jacobi, seed)
        d = lambda t: None if t is None else t.double()
        for xa, xoa, f1, f2 in ((xc, xo, 0.37, 0.81), (None, None, 0.0, 0.81),
                                (xc, None, 0.2, 0.5), (xc, xo, 0.37, 0.0)):
            got = d(dk.dg_cheb(b, xa, xoa, ops[f32], f1, f2))
            for ref in refs:
                want = dk.dg_cheb_plain(d(b), d(xa), d(xoa), ref, f1, f2)
                scale, tol = ((float(want.abs().max()), 1e-5) if f2
                              else (float(xc.abs().max()), 1e-6))
                self.note("dg_cheb<float>" + label, got, want, scale, tol)
        alias = xo.clone()
        dk.dg_cheb(b, xc, alias, ops[f32], 0.37, 0.81, out=alias)
        require(torch.equal(alias, dk.dg_cheb(b, xc, xo, ops[f32], 0.37, 0.81)),
                "dg_cheb<float>: in place into x_old differs")
        return b, xc, xo

    def dg_ops(self, grid):
        """Float32 and float64 DGOperators of ``grid`` with the transformed
        Jacobi installed."""
        from multigrid_tpu_torch.ops import dg_kernel as dk
        from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed

        ops = {}
        for dtype in (torch.float32, torch.float64):
            ops[dtype] = dk.DGOperator(grid, dtype, self.dev)
            ops[dtype].install_jacobi(JacobiTransformed(grid, dtype, self.dev))
        return ops

    def apply_checks(self, ops, face: bool, seed: int = 21, label: str = ""):
        """dg_apply and dg_residual (b - A x) against the plain f64
        operator (and, if ``face``, the face-based one), in double at
        1e-13·max|A x| and in float at 3e-6·max|A x|; one launch a call,
        a repeated call bit for bit.  The errors go under the kernel's name
        plus ``label``.  Returns the float32 inputs (x, b)."""
        from multigrid_tpu_torch.ops import dg_kernel as dk
        from multigrid_tpu_torch.ops.dg_face import DGLaplaceFaceBased

        f32, f64 = torch.float32, torch.float64
        grid = ops[f32].grid
        x, b = (self.rand(grid.shape, f32, seed + s) for s in (0, 1))
        plains = [ops[f64].plain]
        if face:
            plains.append(DGLaplaceFaceBased(grid, f64, self.dev))
        for dtype, tol in ((f64, 1e-13), (f32, 3e-6)):
            name = f"dg_apply<{'double' if dtype == f64 else 'float'}>"
            xt, bt = x.to(dtype), b.to(dtype)
            before = dk.LAUNCHES[name]
            y, r = dk.dg_apply(xt, ops[dtype]), dk.dg_residual(bt, xt,
                                                               ops[dtype])
            require(dk.LAUNCHES[name] - before == 2,
                    f"{name}: not one launch a call")
            require(torch.equal(y, dk.dg_apply(xt, ops[dtype])) and
                    torch.equal(r, dk.dg_residual(bt, xt, ops[dtype])),
                    f"{name}: a repeated call differs")
            for plain in plains:
                want = plain.apply(x.double())
                scale = float(want.abs().max())
                self.note(name + label, y.double(), want, scale, tol)
                self.note(name + label, r.double(), b.double() - want, scale,
                          tol)
        return x, b

    def cg_fused_checks(self, ops, timed: bool):
        """The fused CG's kernels (float64) against their plain versions at
        dg_apply<double>'s bar, 1e-13 of each output's max and the device
        scalars to 1e-13 relative: ``dg_cg`` (x, p, q, p . q, alpha) and
        ``dg_jacobi_cg`` (r, z, beta, rz, rr; also as the first pass); two
        launches a call, a repeated call bit for bit.  Timed: each kernel
        and its plain version.  ``ops``: :meth:`dg_ops`'s (its float64
        operator, the Jacobi installed, is all it reads)."""
        from multigrid_tpu_torch.ops import dg_kernel as dk
        from multigrid_tpu_torch.utils.perf_model import dg_matvec_ops

        f64 = torch.float64
        op = ops[f64]
        grid, jac = op.grid, op.jacobi
        p_old, z, x, r, q = (self.rand(grid.shape, f64, s)
                             for s in range(40, 45))
        scal = torch.tensor([0.37, 0.61, 1.7, 0.0, 0.0], dtype=f64,
                            device=self.dev)
        partial = dk.cg_partials(grid, self.dev)

        def note(name, got, want):
            for a, b in zip(got, want):
                self.note(name, a, b, float(b.abs().max()), 1e-13)

        runs = []
        for fn in ("kernel", "kernel", "plain"):
            xs, sc = x.clone(), scal.clone()
            pp, qq = torch.empty_like(x), torch.empty_like(x)
            before = dk.LAUNCHES["dg_cg<double>"]
            if fn == "kernel":
                dk.dg_cg(p_old, z, xs, sc, pp, qq, op, partial)
                require(dk.LAUNCHES["dg_cg<double>"] - before == 2,
                        "dg_cg<double>: not two launches a call")
            else:
                dk.dg_cg_plain(p_old, z, xs, sc, pp, qq, op.plain.apply)
            runs.append((xs, pp, qq, sc))
        require(all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])),
                "dg_cg<double>: a repeated call differs")
        note("dg_cg<double>", runs[0][:3], runs[2][:3])
        for i in (dk.PQ, dk.ALPHA):
            self.note("dg_cg<double>", runs[0][3][i], runs[2][3][i],
                      float(runs[2][3][i].abs()), 1e-13)
        for first in (False, True):
            got = []
            for fn in ("kernel", "plain"):
                rs, sc, zs = r.clone(), scal.clone(), torch.empty_like(r)
                if fn == "kernel":
                    dk.dg_jacobi_cg(rs, None if first else q, sc, zs, op,
                                    partial, first)
                else:
                    dk.dg_jacobi_cg_plain(rs, q, sc, zs, jac.vmult, first)
                got.append((rs, zs, sc))
            (rk, zk, sk), (rp, zp, sp) = got
            note("dg_jacobi_cg<double>", (rk, zk), (rp, zp))
            for i in (dk.RZ, dk.RR) + (() if first else (dk.BETA,)):
                self.note("dg_jacobi_cg<double>", sk[i], sp[i],
                          float(sp[i].abs()), 1e-13)
            require(not first or (torch.equal(rk, r)
                                  and float(sk[dk.BETA]) == 0.0),
                    "dg_jacobi_cg<double>: the first pass moved r or beta")
        if not timed:
            return
        xs, sc = x.clone(), scal.clone()
        pp, qq = torch.empty_like(x), torch.empty_like(x)
        rs, zs = r.clone(), torch.empty_like(r)
        for name, fn, plain in (
                ("dg_cg<double>",
                 lambda: dk.dg_cg(p_old, z, xs, sc, pp, qq, op, partial),
                 lambda: dk.dg_cg_plain(p_old, z, xs, sc, pp, qq,
                                        op.plain.apply)),
                ("dg_jacobi_cg<double>",
                 lambda: dk.dg_jacobi_cg(rs, q, sc, zs, op, partial),
                 lambda: dk.dg_jacobi_cg_plain(rs, q, sc, zs, jac.vmult))):
            self.ms[name] = time_ms(fn)
            self.plain_ms[name] = time_ms(plain)
        # bytes: x, p_old, z in, x, p, q out (dg_cg); r, q, inv_diag in, r,
        # z out (dg_jacobi_cg).  Flops: the operator and the two updates
        # and the dot; the six 1-D sweeps of P^-1, its scaling, the
        # residual update and two dots
        n_dofs, n = grid.n_dofs, grid.n
        flops = dg_matvec_ops(3, grid.degree, int(np.prod(grid.cells)),
                              grid.kind)
        self.bound["dg_cg<double>"] = bound(6 * 8 * n_dofs,
                                            flops + 6 * n_dofs, f64)
        self.bound["dg_jacobi_cg<double>"] = bound(
            5 * 8 * n_dofs, (12 * n + 7) * n_dofs, f64)

    def dg_checks(self, grid, timed: bool, label: str = ""):
        """The DG kernels against the plain f64 operator (and the
        face-based one on the small grids): dg_apply and dg_residual by
        :meth:`apply_checks`, dg_cheb<float> by :meth:`cheb_checks`; the
        timed plain versions run in the kernel's dtype.  The numbers go
        under the kernels' names plus ``label`` (" p=8": the entries of the
        degree-8 kernels)."""
        from multigrid_tpu_torch.ops import dg_kernel as dk
        from multigrid_tpu_torch.utils.perf_model import dg_matvec_ops

        f32, f64 = torch.float32, torch.float64
        ops = self.dg_ops(grid)
        x, br = self.apply_checks(ops, face=not timed, label=label)
        x64, br64 = x.double(), br.double()
        b, xc, xo = self.cheb_checks(ops, face=not timed, label=label)
        if not label:
            self.cg_fused_checks(ops, timed)
        if not timed:
            return
        for name, fn, plain in (
                ("dg_apply<double>", lambda: dk.dg_apply(x64, ops[f64]),
                 lambda: dk.dg_apply_plain(x64, ops[f64])),
                ("dg_apply<float>", lambda: dk.dg_apply(x, ops[f32]),
                 lambda: dk.dg_apply_plain(x, ops[f32])),
                ("dg_cheb<float>",
                 lambda: dk.dg_cheb(b, xc, xo, ops[f32], 0.37, 0.81),
                 lambda: dk.dg_cheb_plain(b, xc, xo, ops[f32], 0.37, 0.81))):
            self.ms[name + label] = time_ms(fn)
            self.plain_ms[name + label] = time_ms(plain)
        # bytes: x in, y out (residual: x, b in, out; dg_cheb: x, b, x_old,
        # inv_diag in, out); flops: the sum-factorized operator, plus one a
        # dof for the residual and, for dg_cheb, the six 1-D sweeps of the
        # transformed Jacobi, its scaling, the residual and the update
        n_dofs, n = grid.n_dofs, grid.n
        flops = dg_matvec_ops(3, grid.degree, int(np.prod(grid.cells)),
                              grid.kind)
        for name, xt, bt, dtype in (("dg_apply<double>", x64, br64, f64),
                                    ("dg_apply<float>", x, br, f32)):
            size = xt.element_size()
            self.bound[name + label] = bound(2 * size * n_dofs, flops, dtype)
            self.residual[name + label] = dict(
                ms=time_ms(lambda: dk.dg_residual(bt, xt, ops[dtype])),
                plain_ms=time_ms(
                    lambda: dk.dg_residual_plain(bt, xt, ops[dtype])),
                bound=bound(3 * size * n_dofs, flops + n_dofs, dtype))
        self.bound["dg_cheb<float>" + label] = bound(
            5 * 4 * n_dofs, flops + (12 * n + 6) * n_dofs, f32)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    from multigrid_tpu_torch import _build
    from multigrid_tpu_torch.solvers.multigrid import set_full_precision_matmul

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    set_full_precision_matmul()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")

    # phase 1: build from the sources in this checkout
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    if _build.build_seconds:
        print("  nvcc seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(_build.build_seconds.items(),
                                               key=lambda kv: -kv[1])))
    # registers and spills per source (ptxas -v); no brick kernel at p =
    # 1..9 may spill, nor a DG pencil kernel at p = 4, 8 or 9 (n = 5, 9,
    # 10: the paths' degrees); the kernels at p = 10..16 (the *_wide
    # sources) print theirs, spills included
    report = _build.ptxas_report(_build.build_log)
    if not report:
        print("  ptxas: the library was built before this run; no compiler "
              "output to read")
    for src in dict.fromkeys(r["source"] for r in report):
        rows = [r for r in report if r["source"] == src]
        regs = [r["registers"] for r in rows]
        spills = [r["kernel"] for r in rows
                  if r["spill_stores"] or r["spill_loads"]]
        print(f"  ptxas: {src}: {len(rows)} kernels, registers {min(regs)}-"
              f"{max(regs)}, spilling: {spills or 'none'}")
        wide = "_wide" in src
        require(not src.startswith("brick_kron") or wide or not spills,
                f"a brick_kron kernel spills ({src}): {spills}")
        if wide:
            for r in rows:
                print(f"    {r['kernel']}: {r['registers']} registers, spill "
                      f"stores {r['spill_stores']} B, loads "
                      f"{r['spill_loads']} B")
        if src.startswith("brick_kron"):
            for r in rows:
                if ("brick_cell_kernelI" in r["kernel"]
                        or "brick_layer_kernelI" in r["kernel"]) and any(
                        f"Li{p}ELi" in r["kernel"] for p in HIGH_DEGREE_SIZES):
                    print(f"    {r['kernel']}: {r['registers']} registers, "
                          f"spill stores {r['spill_stores']} B, loads "
                          f"{r['spill_loads']} B")
        if src in ("dg_pencil.cu", "dg_pencil_f64.cu", "dg_cg_f64.cu",
                   "dg_pencil_high.cu"):
            for r in rows:
                print(f"    {r['kernel']}: {r['registers']} registers, spill "
                      f"stores {r['spill_stores']} B, loads "
                      f"{r['spill_loads']} B")
            require(not [k for k in spills
                         if any(f"Li{n}E" in k for n in (5, 9, 10))],
                    f"a DG pencil kernel spills at p = 4, 8 or 9: {spills}")
            require(src != "dg_pencil_high.cu" or not spills,
                    f"a kernel of dg_pencil_high.cu spills: {spills}")
    if report:
        names = [r["kernel"] for r in report]
        require(not [k for k in names if "9dg_kernelI" in k],
                "the cell-per-block dg_kernel is still in the library")
        require(sum("15dg_apply_kernelI" in k for k in names) == 34
                and sum("14dg_cheb_kernelI" in k for k in names) == 7
                and sum("20dg_high_apply_kernelI" in k for k in names) == 2
                and sum("19dg_high_cheb_kernelI" in k for k in names) == 2
                and sum("12dg_cg_kernelI" in k for k in names) == 9
                and sum("19dg_jacobi_cg_kernelI" in k for k in names) == 9
                and sum("14dg_wide_kernelIf" in k for k in names) == 21
                and sum("14dg_wide_kernelId" in k for k in names) == 14,
                "the DG pencil kernels are not all in the library: the "
                "template (the step at p = 1..7, the float apply at p = "
                "1..9, the double one at p = 1..7, 9), dg_pencil_high.cu's "
                "step at p = 8, 9 and double apply at p = 8, the wide "
                "pencils' every mode at p = 10..16")
        require(sum("17brick_kron_kernelI" in k for k in names) == 120
                and sum("17brick_cell_kernelI" in k for k in names) == 16
                and sum("18brick_layer_kernelIf" in k for k in names) == 8,
                "brick_kron is not in the library at p = 1..16, both types, "
                "all four modes (the march at p = 1..7, in float at p = 8, "
                "9 and in both types at p = 10..16; the cell form at p = 8, "
                "9; the layer march in float at p = 8, 9)")

    high_tiles()
    wide_tiles()
    return run(dev, card, t_start)


def wide_tiles() -> None:
    """The tile of each DG pencil kernel at p = 10..16
    (``dg_pencil_wide*.cu``, ``dg_kernel.wide_tile``: cells a pencil,
    shared bytes, threads, blocks an SM, registers and local bytes a
    thread); fails on a tile that exceeds a block's shared memory or that
    no SM holds."""
    from multigrid_tpu_torch.ops import dg_kernel as dk

    for p in dk.WIDE_DEGREES:
        for name, tile in dk.wide_tile(p + 1).items():
            print(f"  dg_pencil_wide p={p} {name}: " + ", ".join(
                f"{k} {v}" for k, v in tile.items()))
            require(tile["smem_bytes"] <= 232448
                    and tile["blocks_per_sm"] >= 1,
                    f"{name} at p = {p}: {tile}")


def high_tiles() -> None:
    """The tile of each DG pencil kernel at p = 8, 9 (``dg_pencil_high.cu``:
    cells a pencil, shared bytes, threads, blocks an SM from the occupancy
    calculator, registers and local bytes a thread); fails on a spill
    (local bytes)."""
    from multigrid_tpu_torch.ops import dg_kernel as dk

    for n in dk.HIGH_KERNELS_AT:
        for name, tile in dk.high_tile(n).items():
            print(f"  dg_pencil_high p={n - 1} {name}: " + ", ".join(
                f"{k} {v}" for k, v in tile.items()))
            require(tile["local_bytes"] == 0,
                    f"{name} at p = {n - 1} spills: {tile}")


def _counters():
    from multigrid_tpu_torch.ops import cg_kernel, dg_kernel, laplace_kernel

    return (laplace_kernel, cg_kernel, dg_kernel)


# dg_kernel.high_launches() at the last reset: the C code's own counts of
# dg_pencil_high.cu's launches, which only grow
_HIGH_BASE = {}


def reset_launches() -> None:
    from multigrid_tpu_torch.ops import dg_kernel

    for mod in _counters():
        mod.reset_launches()
    _HIGH_BASE.update(dg_kernel.high_launches())


def read_launches() -> dict:
    """The kernels' launch counts, brick_kron's by node grid under
    "<kernel> ZxYxX" and, under "<kernel> high", those of the DG pencils
    that ``dg_pencil_high.cu`` counted where it launched its kernels."""
    from multigrid_tpu_torch.ops import dg_kernel, laplace_kernel

    out = {}
    for mod in _counters():
        out.update(mod.LAUNCHES)
    out.update({f"{k} high": n - _HIGH_BASE.get(k, 0)
                for k, n in dg_kernel.high_launches().items()})
    for (name, shape), n in laplace_kernel.LAUNCHES_BY_GRID.items():
        out[f"{name} {'x'.join(map(str, shape))}"] = n
    return out


def dg_grid(cells, degree, kind, seed=0):
    """A sheared affine DG grid (the cells of tests/test_pallas_dg.py)."""
    from multigrid_tpu_torch.ops.dg import DGGrid

    rng = np.random.default_rng(seed)
    J = np.diag(1.0 / np.array(cells)) @ (np.eye(3) + 0.08 * rng.random((3, 3)))
    return DGGrid(cells=cells, jacobian=tuple(map(tuple, J)), degree=degree,
                  kind=kind)


def brick(cells, degree):
    """An anisotropic brick of ``cells`` at ``degree`` (one level)."""
    from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid

    return DofGrid(BrickMesh(cells, (-0.9,) * 3, (1.9, 1.3, 1.1)), 0, degree)


def kron_wide_digests(dev) -> dict:
    """``"<case> <type> <mode>"`` -> the digest of brick_kron's output at
    the cases of :data:`KRON_WIDE_CASES` on the inputs of seeds 1 (x), 2
    (b), 3 (x_old), f1 = 0.37, f2 = 0.81."""
    import hashlib

    from multigrid_tpu_torch.ops import laplace_kernel as lk

    rand = KernelChecks(dev).rand
    out = {}
    for case, (cells, p) in KRON_WIDE_CASES.items():
        g = brick(cells, p)
        for dtype in (torch.float32, torch.float64):
            op = lk.BrickLaplace(g, dtype, dev)
            x, b, xo = (rand(g.shape, dtype, s) for s in (1, 2, 3))
            for mode in lk.KRON_MODES:
                y = lk.brick_kron(x, op, mode, b=b, x_old=xo, f1=0.37,
                                  f2=0.81)
                out[f"{case} {KRON_BARS[dtype][0]} {mode}"] = hashlib.sha256(
                    y.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def kernel_checks(dev: torch.device, card: str) -> "KernelChecks":
    """Phase 2 on ``dev``: every kernel against its plain version, each
    block's wall seconds on its line."""
    from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
    from multigrid_tpu_torch.solvers.multigrid_dg import dg_grid_from_mesh

    checks = KernelChecks(dev)
    last = [time.perf_counter()]

    def took() -> str:
        now = time.perf_counter()
        s = f"({now - last[0]:.1f} s)"
        last[0] = now
        return s
    shapes = [
        ("poisson_cube_mesh(8)", DofGrid(poisson_cube_mesh(8), 3, 4), False),
        ("anisotropic (3,4,5)", brick((3, 4, 5), 4), False),
        (f"poisson_cube_mesh({SIZE})",
         DofGrid(poisson_cube_mesh(SIZE), poisson_cube_mesh(SIZE).max_level, 4),
         True),
    ]
    for label, grid, timed in shapes:
        checks.operator_checks(grid, timed)
        checks.cg_checks(grid.n_dofs, timed)
        torch.cuda.synchronize()
        print(f"kernel checks passed at {label}: {grid.shape} {took()}")
    # brick_kron (float and double) at every other degree, a one-cell axis,
    # node counts that do not divide its tile
    for label, grid in (
            ("poisson_cube_mesh(8) p=1", DofGrid(poisson_cube_mesh(8), 3, 1)),
            ("poisson_cube_mesh(8) p=2", DofGrid(poisson_cube_mesh(8), 3, 2)),
            ("poisson_cube_mesh(8) p=3", DofGrid(poisson_cube_mesh(8), 3, 3)),
            ("poisson_cube_mesh(4) p=6", DofGrid(poisson_cube_mesh(4), 2, 6)),
            ("poisson_cube_mesh(4) p=7", DofGrid(poisson_cube_mesh(4), 2, 7)),
            ("one-cell axis (1,4,3) p=4", brick((1, 4, 3), 4)),
            ("one-cell axis (1,4,3) p=7", brick((1, 4, 3), 7)),
            ("ragged (7,5,9) p=3", brick((7, 5, 9), 3)),
            ("ragged (3,12,20) p=5", brick((3, 12, 20), 5))):
        for dtype in (torch.float32, torch.float64):
            checks.kron_checks(grid, False, dtype)
        torch.cuda.synchronize()
        print(f"brick_kron checks passed at {label}: {grid.shape} {took()}")
    # p = 8 and 9: small grids (a one-cell axis, ragged tiles), then the
    # cube rows' node grids, timed
    for p, size in HIGH_DEGREE_SIZES.items():
        mesh = poisson_cube_mesh(size)
        for label, grid, timed in (
                ("poisson_cube_mesh(4)", DofGrid(poisson_cube_mesh(4), 2, p),
                 False),
                ("one-cell axis (1,4,3)", brick((1, 4, 3), p), False),
                ("ragged (3,5,9)", brick((3, 5, 9), p), False),
                (f"poisson_cube_mesh({size})",
                 DofGrid(mesh, mesh.max_level, p), True)):
            for dtype in (torch.float32, torch.float64):
                checks.kron_checks(grid, timed, dtype, label=f" p={p}")
            if timed:
                checks.layer_checks(grid, f" p={p}")
            torch.cuda.synchronize()
            print(f"brick_kron checks passed at {label} p={p}: {grid.shape} "
                  f"{took()}")
        for c in HIGH_DEGREE_COARSE[p]:
            grid = DofGrid(poisson_cube_mesh(c), 0, p)
            for dtype in (torch.float32, torch.float64):
                checks.kron_checks(grid, True, dtype,
                                   label=f" p={p} {c * p + 1}^3")
            torch.cuda.synchronize()
            print(f"brick_kron checks passed at the coarse grid {c}^3 cells "
                  f"p={p}: {grid.shape} {took()}")
    # p = 10..16 (the z-slab march in both types): a cube of 2^3 cells, a
    # one-cell axis or a grid ragged against the tile, by turns (the
    # digests below hold more); then at p = 10 and 16 the cube rows' node
    # grids, timed; then the pinned bits
    for p in WIDE_DEGREES:
        label = f" p={p}" if p in WIDE_CUBE_SIZES else ""
        cells = ((2, 2, 2), (1, 3, 2), (3, 2, 4))[p % 3]
        for dtype in (torch.float32, torch.float64):
            checks.kron_checks(brick(cells, p), False, dtype, label=label)
        if p in WIDE_CUBE_SIZES:
            mesh = poisson_cube_mesh(WIDE_CUBE_SIZES[p])
            grid = DofGrid(mesh, mesh.max_level, p)
            for dtype in (torch.float32, torch.float64):
                checks.kron_checks(grid, True, dtype, label=label)
        torch.cuda.synchronize()
        print(f"brick_kron checks passed at p={p}: {cells} cells"
              + (f", poisson_cube_mesh({WIDE_CUBE_SIZES[p]}) timed"
                 if label else "") + f" {took()}")
    got = kron_wide_digests(dev)
    differ = sorted(k for k in KRON_WIDE_DIGESTS
                    if got.get(k) != KRON_WIDE_DIGESTS[k])
    require(len(got) == len(KRON_WIDE_DIGESTS) and not differ,
            f"brick_kron digests at p = 10..16 differ: {differ}")
    print(f"brick_kron digests: all {len(got)} at p = 10..16 equal the "
          f"pinned ones {took()}")
    dg_mesh = poisson_cube_mesh(DG_SIZE)
    dg_shapes = [
        ("sheared DG (3,2,4) p=3 hermite", dg_grid((3, 2, 4), 3, "hermite"),
         False),
        ("sheared DG (4,1,3) p=4 gauss", dg_grid((4, 1, 3), 4, "gauss"),
         False),
        (f"DG poisson_cube_mesh({DG_SIZE}) p=4 hermite",
         dg_grid_from_mesh(dg_mesh, dg_mesh.max_level, 4, "hermite"), True),
    ]
    for label, grid, timed in dg_shapes:
        checks.dg_checks(grid, timed)
        torch.cuda.synchronize()
        print(f"kernel checks passed at {label}: {grid.shape} {took()}")
    # the DG pencil kernels at every compiled degree, on x axes that are
    # not a multiple of the pencil or have one cell (p = 8, 9, 10, 16:
    # under their own entries, then timed on the grids of their paths);
    # the fused CG's kernels at theirs (p = 1..9)
    for p in range(1, dk.MAX_DEGREE + 1):
        label = (f" p={p}" if p in HIGH_DEGREE_SIZES or p in WIDE_DG_SIZES
                 else "")
        cg = p <= dk.CG_MAX_DEGREE
        for cells, kind in (((3, 2, 5), "hermite"), ((2, 3, 1), "gll"),
                            ((5, 4, 9) if cg else (5, 4, 3),
                             "gauss" if p % 2 else "hermite")):
            ops = checks.dg_ops(dg_grid(cells, p, kind))
            checks.apply_checks(ops, face=True, label=label)
            checks.cheb_checks(ops, face=True, label=label)
            if cg:
                checks.cg_fused_checks(ops, False)
        high = dk.HIGH_CELLS if p in HIGH_DEGREE_SIZES else ()
        for i, cells in enumerate(high):
            # dg_pencil_high.cu's edges (p = 8, 9): one-cell axes, ragged
            # pencils, many pencils
            grid = dg_grid(cells, p, ("hermite", "gll", "gauss")[(p + i) % 3])
            ops = checks.dg_ops(grid)
            checks.apply_checks(ops, face=True, label=label)
            checks.cheb_checks(ops, face=True, label=label)
        for i, cells in enumerate(dk.MARCH_CELLS if cg else ()):
            grid = dg_grid(cells, p, ("hermite", "gll", "gauss")[(p + i) % 3])
            op = dk.DGOperator(grid, torch.float64, dev)
            op.install_jacobi(JacobiTransformed(grid, torch.float64, dev))
            checks.cg_fused_checks({torch.float64: op}, False)
        torch.cuda.synchronize()
        if cg:
            print(f"dg_apply, dg_residual, dg_cheb, dg_cg and dg_jacobi_cg "
                  f"checks passed at p={p}: (3,2,5), (2,3,1), (5,4,9), "
                  + (f"the high-degree cells {list(high)}, " if high else "")
                  + f"dg_cg's march cells {list(dk.MARCH_CELLS)} {took()}")
        else:
            print(f"dg_apply, dg_residual and dg_cheb checks passed at "
                  f"p={p}: (3,2,5), (2,3,1), (5,4,3) {took()}")
    # the DG kernels' bits: every mode at every degree and kind, as pinned
    digests = dk.kernel_digests(dev)
    differ = sorted(k for k in DG_DIGESTS if digests.get(k) != DG_DIGESTS[k])
    require(len(digests) == len(DG_DIGESTS) and not differ,
            f"DG kernel digests differ from the pinned ones: {differ}")
    print(f"DG kernel digests: all {len(digests)} (p = 1..{dk.MAX_DEGREE}, "
          f"every kind and mode) equal the pinned ones {took()}")
    # no fallback above the kernels' degree: the card refuses such a level
    try:
        dk.DGOperator(dg_grid((2, 2, 2), dk.MAX_DEGREE + 1, "hermite"),
                      torch.float32, dev)
    except ValueError as e:
        require("no DG kernel" in str(e), f"p = {dk.MAX_DEGREE + 1}: {e}")
        print(f"a 3-D DG level at p = {dk.MAX_DEGREE + 1} is refused: {e}")
    else:
        raise AssertionError(f"a 3-D DG level at p = {dk.MAX_DEGREE + 1} was "
                             "built on the card")
    high_mesh = poisson_cube_mesh(DG_HIGH_SIZE)
    for p in HIGH_DEGREE_SIZES:
        grid = dg_grid_from_mesh(high_mesh, high_mesh.max_level, p, "hermite")
        checks.dg_checks(grid, True, label=f" p={p}")
        torch.cuda.synchronize()
        print(f"kernel checks passed at DG poisson_cube_mesh({DG_HIGH_SIZE}) "
              f"p={p} hermite: {grid.shape} {took()}")
    for p, size in WIDE_DG_SIZES.items():
        mesh = poisson_cube_mesh(size)
        grid = dg_grid_from_mesh(mesh, mesh.max_level, p, "hermite")
        checks.dg_checks(grid, True, label=f" p={p}")
        torch.cuda.synchronize()
        print(f"kernel checks passed at DG poisson_cube_mesh({size}) p={p} "
              f"hermite: {grid.shape} {took()}")
    for k in KERNELS:
        lib = checks.library_ms[k]
        print(f"  {k}: max|err| {checks.err[k]:.3e} ({checks.rel[k]:.2e} of "
              f"the bar's scale), kernel "
              f"{checks.ms[k]:.4f} ms, plain {checks.plain_ms[k]:.4f} ms, "
              f"library {'-' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{checks.bound[k][0]:.4f} ms ({checks.bound[k][1]}) [{card}]")
    for k, res in checks.residual.items():
        print(f"  {k} residual mode: kernel {res['ms']:.4f} ms, plain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound'][0]:.4f} ms "
              f"({res['bound'][1]}) [{card}]")
    return checks


def run(dev: torch.device, card: str, t_start: float) -> int:
    """Phase 2 on ``dev``: the kernel checks; then the paths."""
    from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops import laplace_kernel as lk

    laps = [time.perf_counter()]
    checks = kernel_checks(dev, card)

    # phases 3 to 16: the paths, each with the counters zeroed just before
    # it and read just after; each phase's wall seconds on its own line

    def lap(name: str) -> None:
        torch.cuda.empty_cache()
        now = time.perf_counter()
        print(f"path {name}: {now - laps[0]:.1f} s")
        laps[0] = now

    lap("kernel checks")
    launches = {}
    launches["poisson_cube"], cube_row = cube_path(dev, card, checks)
    lap("poisson_cube")
    for p, size in HIGH_DEGREE_SIZES.items():
        launches[degree_path(p)] = cube_degree_path(dev, card, p, size)
        lap(degree_path(p))
    for p, size in WIDE_CUBE_SIZES.items():
        launches[degree_path(p)] = cube_wide_path(dev, card, p, size)
        lap(degree_path(p))
    launches["poisson_dg"], dg_sol, dg_err = dg_path(dev, card, checks)
    lap("poisson_dg")
    launches["poisson_dg_plain"], plain_err = dg_plain_path(dev, card, dg_sol,
                                                            dg_err)
    del dg_sol
    lap("poisson_dg_plain")
    launches["solver_dg"] = solver_dg_path(dev, card)
    lap("solver_dg")
    high = {}
    for path, p in DG_HIGH_PATHS:
        launches[degree_path(p, path)], high[path, p] = dg_high_path(
            dev, card, path, p, high.get(("poisson_dg", p)))
        lap(degree_path(p, path))
    del high
    wide = {}
    for path, p in WIDE_DG_PATHS:
        launches[degree_path(p, path)], wide[path, p] = dg_wide_path(
            dev, card, path, p, wide.get(("poisson_dg", p)))
        lap(degree_path(p, path))
    del wide
    launches["poisson_shell"] = general_path(dev, card)
    lap("poisson_shell")
    launches["poisson_dg_plain_curved"] = dg_curved_path(dev, card, checks,
                                                         plain_err)
    lap("poisson_dg_plain_curved")
    launches["poisson_l"] = l_path(dev, card, checks)
    lap("poisson_l")
    launches["poisson_dg_plain_2d"], plain2_ref = dg_plain_2d_path(dev, card)
    lap("poisson_dg_plain_2d")
    launches.update(matvec_rows_path(dev))
    lap("matvec_dg rows")
    launches["poisson_cube_2d"], cube2_row = cube_2d_path(dev, card)
    lap("poisson_cube_2d")
    launches["poisson_dg_2d"], dg2_ref = dg_2d_path(dev, card)
    lap("poisson_dg_2d")
    launches["poisson_cube_135M"], big_row = utils_path(dev, card)
    lap("poisson_cube_135M")
    sym_coef_check(dev, card)
    lap("SymCoef check")
    (launches["poisson_cube_ranks"], launches["poisson_dg_ranks"],
     launches["poisson_dg_ranks_2d"]) = rank_paths(
        dev, card, {(3, SIZE): cube_row, (3, MEM_SIZE): big_row,
                    (2, CUBE2_SIZE): cube2_row}, dg_err,
        {"dg-plain": plain2_ref, "dg": dg2_ref})
    lap("poisson_cube_ranks, poisson_dg_ranks and poisson_dg_ranks_2d")
    for path in ("poisson_dg_plain", degree_path(8, "poisson_dg_plain"),
                 degree_path(10, "poisson_dg_plain")):
        off_path = {k: v for k, v in launches[path].items()
                    if k.startswith(("brick_kron", "cheb_epilogue")) and v}
        require(not off_path, f"the {path} solves launched {off_path}")
    for path in PLAIN_PATHS:
        off_path = {k: v for k, v in launches[path].items()
                    if k not in CG_KERNELS and v}
        require(not off_path, f"the {path} solves launched {off_path}")
    require(not any(launches["matvec_dg_plain"].values()),
            f"the plain matvec_dg rows launched {launches['matvec_dg_plain']}")
    for path, names in (("poisson_cube", CUBE_KERNELS),
                        *((degree_path(p), CUBE_KERNELS)
                          for p in HIGH_DEGREE_SIZES),
                        ("poisson_dg", DG_KERNELS),
                        ("poisson_dg_plain", DG_PLAIN_KERNELS),
                        ("solver_dg", SOLVER_DG_KERNELS),
                        *((degree_path(p, path),
                           DG_KERNELS if path == "poisson_dg"
                           else DG_PLAIN_KERNELS)
                          for path, p in DG_HIGH_PATHS + WIDE_DG_PATHS),
                        *((degree_path(p), CUBE_KERNELS)
                          for p in WIDE_CUBE_SIZES),
                        *((degree_path(p, "matvec_dg"), ["dg_apply<double>"])
                          for p in MATVEC_KERNEL),
                        *((path, CG_KERNELS) for path in PLAIN_PATHS),
                        ("matvec_dg_plain", []),
                        ("poisson_cube_135M", CUBE_KERNELS),
                        ("poisson_cube_ranks", CUBE_KERNELS),
                        ("poisson_dg_ranks", DG_KERNELS)):
        print(f"launches during the {path} solves: {launches[path]}")
        for k in names:
            require(launches[path][k] > 0,
                    f"kernel {k} was not launched by the {path} solves")
    # the step at p = 8, 9 and the double apply at p = 8 run
    # dg_pencil_high.cu's kernels (dg_kernel.HIGH_DEGREES); elsewhere the
    # template
    for path, p in DG_HIGH_PATHS:
        for k, degrees in dk.HIGH_DEGREES.items():
            n = launches[degree_path(p, path)][f"{k} high"]
            want = launches[degree_path(p, path)][k] if p in degrees else 0
            require(n == want and (n > 0 or p not in degrees),
                    f"the {degree_path(p, path)} solves launched {k} "
                    f"{launches[degree_path(p, path)][k]} times, {n} in "
                    "dg_pencil_high.cu")
    for path in ("poisson_dg", "poisson_dg_plain", "solver_dg",
                 *(degree_path(p, path) for path, p in WIDE_DG_PATHS)):
        high = {k: v for k, v in launches[path].items()
                if k.endswith(" high") and v}
        require(not high, f"the {path} solves ran dg_pencil_high.cu: {high}")
    # the coarse grids' Chebyshev steps: the cube row's at p = 9, the
    # poisson_dg rows' FE_Q(p) coarse level at p = 8, 9
    for path, cells, p in ((degree_path(9), 7, 9),
                           (degree_path(9, "poisson_dg"), 3, 9),
                           (degree_path(8, "poisson_dg"), 3, 8)):
        key = f"brick_kron_cheb<float> {'x'.join([str(cells * p + 1)] * 3)}"
        require(launches[path].get(key, 0) > 0,
                f"the {path} solves launched no {key}")
    # the layer march on the p = 8, 9 cube and poisson_dg paths: the float
    # A x and step at the grids brick_form gives it (the finest levels)
    for path, p in ((degree_path(8), 8), (degree_path(9), 9),
                    (degree_path(8, "poisson_dg"), 8),
                    (degree_path(9, "poisson_dg"), 9)):
        for name in ("brick_kron<float>", "brick_kron_cheb<float>"):
            n = sum(v for k, v in launches[path].items()
                    if k.startswith(name + " ") and lk.brick_form(
                        tuple(map(int, k.split()[-1].split("x"))), p,
                        torch.float32) == "layer")
            require(n > 0, f"the {path} solves launched no {name} in the "
                           "layer march")

    def counted(kernel: str) -> dict:
        """Launches of ``kernel`` by path: an entry of degree p counts the
        paths of that degree (:func:`degree_path`), an unlabelled entry
        every other path; an entry of a node grid ("... p=9 64^3") only
        the launches at that grid, and a brick_kron entry of degree p
        without one only those at the grids of the form it was timed in
        (``brick_form`` at the cube row's node grid: the layer march in
        float, the cell form in double)."""
        base, _, label = kernel.partition(" p=")
        deg, _, grid = label.partition(" ")
        want = int(deg) if deg else None
        key = f"{base} {'x'.join([grid[:-2]] * 3)}" if grid else base
        if (want is None or grid or not base.startswith("brick_kron")
                or want not in HIGH_DEGREE_SIZES):
            return {p: launches[p].get(key, 0) for p in launches
                    if path_degree(p) == want}
        dtype = torch.float32 if "<float>" in base else torch.float64
        mesh = poisson_cube_mesh(HIGH_DEGREE_SIZES[want])
        form = lk.brick_form(DofGrid(mesh, mesh.max_level, want).shape, want,
                             dtype)
        return {p: sum(n for k, n in launches[p].items()
                       if k.startswith(base + " ") and lk.brick_form(
                           tuple(map(int, k.split()[-1].split("x"))), want,
                           dtype) == form)
                for p in launches if path_degree(p) == want}

    kernels = []
    for k, (src, rep) in KERNELS.items():
        by_path = counted(k)
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=checks.err[k], ms=checks.ms[k],
            plain_ms=checks.plain_ms[k], bound_ms=checks.bound[k][0],
            bound_by=checks.bound[k][1], library_ms=checks.library_ms[k]))
        if k in checks.residual:
            res = checks.residual[k]
            kernels[-1].update(residual_ms=res["ms"],
                               residual_plain_ms=res["plain_ms"],
                               residual_bound_ms=res["bound"][0])
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s with the build")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cube_path(dev, card, checks):
    """poisson_cube at size 64: FMG and CG, best of 3 each; returns the
    device kernels launched by the solves and the row (its CG solution in
    a file under ``SCRATCH``)."""
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh

    # a small solve on the card against the same solve on the CPU
    small = poisson_cube_mesh(4)
    u_gpu = build_solver(small, 4, device=dev).solve().cpu()
    u_cpu = build_solver(small, 4, device="cpu").solve()
    diff = float((u_gpu - u_cpu).abs().max())
    require(diff <= 1e-5 * float(u_cpu.abs().max()),
            f"size-4 FMG on the card vs CPU: max diff {diff:.3e}")
    print(f"size-4 FMG card vs CPU: max diff {diff:.3e}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build_solver(poisson_cube_mesh(SIZE), 4, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_dofs = solver.grids[solver.maxlevel].n_dofs
    print(f"setup: {setup_s:.2f} s for {n_dofs} dofs [{card}]")

    reset_launches()
    fmg_s = []
    sol = None
    for _ in range(3):
        sol = None
        t0 = time.perf_counter()
        sol = solver.solve()
        torch.cuda.synchronize()
        fmg_s.append(time.perf_counter() - t0)
    _, report, reduction = solver.solve_analyze()
    cg_s = []
    sol_cg = None
    for _ in range(3):
        sol_cg = None
        t0 = time.perf_counter()
        sol_cg, its, cg_red = solver.solve_cg()
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = read_launches()

    fmg_l2 = solver.l2_error(solver.maxlevel, sol)
    cg_l2 = solver.l2_error(solver.maxlevel, sol_cg)
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"fmg: {min(fmg_s):.4f} s (runs {', '.join(f'{s:.4f}' for s in fmg_s)})"
          f", L2 {fmg_l2:.4e}, V-cycle reduction {reduction:.4e} [{card}]")
    print(f"cg: {min(cg_s):.4f} s (runs {', '.join(f'{s:.4f}' for s in cg_s)})"
          f", {its} its, reduction {cg_red:.4e}, L2 {cg_l2:.4e} [{card}]")
    print(f"max_memory_allocated: {mem} bytes [{card}]")
    for name, fn, dtype in (("dp", solver.do_matvec, solver.f_dtype),
                            ("sp", solver.do_matvec_smoother, solver.v_dtype)):
        x = checks.rand(solver.grids[solver.maxlevel].shape, dtype, 0)
        ms = time_ms(lambda: fn(x))
        print(f"{name} matvec: {ms / 1e3:.6f} s, {n_dofs / (ms / 1e3):.4e} "
              f"DoF/s [{card}]")

    require(its == CG_ITS, f"cg_its {its} != {CG_ITS}")
    require(abs(cg_red / CG_REDUCTION - 1) <= ROW_TOL,
            f"cg reduction {cg_red:.4e} vs {CG_REDUCTION}")
    require(abs(reduction / VCYCLE_REDUCTION - 1) <= ROW_TOL,
            f"V-cycle reduction {reduction:.4e} vs {VCYCLE_REDUCTION}")
    for name, v in (("fmg", fmg_l2), ("cg", cg_l2)):
        require(np.isfinite(v) and v < L2_BOUND, f"{name} L2 error {v}")
    require(sol.shape == solver.grids[solver.maxlevel].shape
            and bool(torch.isfinite(sol).all()), "FMG solution not finite")
    # the row the rank path is held to, its CG solution in a file
    cg_file = SCRATCH / f"cube{SIZE}_cg.npy"
    SCRATCH.mkdir(parents=True, exist_ok=True)
    np.save(cg_file, sol_cg.cpu().numpy())
    return launches, dict(reduction=reduction, cg_reduction=cg_red,
                          fmg_L2error=fmg_l2, cg_its=its, cg_file=cg_file)


def dg_path(dev, card, checks) -> dict:
    """poisson_dg at size 48 (hermite p = 4, n_pre = n_post = 3, rtol
    1e-9): CG best of 3 after set-up; returns the device kernels launched
    by the solves, the solution and its L2 error."""
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDG
    from multigrid_tpu_torch.utils.perf_model import (dg_matvec_model,
                                                      print_matvec_details)

    def build(mesh, where):
        return MultigridSolverDG(mesh, 4, exact_fn, rhs_fn, kind="hermite",
                                 n_pre=3, n_post=3, device=where)

    # a small solve on the card against the same solve on the CPU
    u_gpu, u_cpu = (build(poisson_cube_mesh(4), where).solve_cg(DG_RTOL)[0].cpu()
                    for where in (dev, "cpu"))
    diff = float((u_gpu - u_cpu).abs().max())
    require(diff <= 1e-5 * float(u_cpu.abs().max()),
            f"size-4 DG solve on the card vs CPU: max diff {diff:.3e}")
    print(f"size-4 DG solve card vs CPU: max diff {diff:.3e}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mesh = poisson_cube_mesh(DG_SIZE)
    solver = build(mesh, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_dofs, n_cells = solver.dg_grid.n_dofs, mesh.n_cells(mesh.max_level)
    print(f"DG setup: {setup_s:.2f} s for {n_dofs} DG dofs, FE_Q finest "
          f"{solver.cg.grids[solver.cg.maxlevel].n_dofs} nodes [{card}]")

    reset_launches()
    cg_s = []
    sol = None
    for _ in range(3):
        sol = None
        t0 = time.perf_counter()
        sol, frac_its, rate = solver.solve_cg(tolerance=DG_RTOL)
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = read_launches()

    err = solver.l2_error(sol, solver.exact_quad)
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"dg cg: {min(cg_s):.4f} s (runs {', '.join(f'{s:.4f}' for s in cg_s)})"
          f", frac its {frac_its:.4f}, rate {rate:.4e}, L2 {err:.6e} [{card}]")
    print(f"DG max_memory_allocated: {mem} bytes [{card}]")
    x = checks.rand(solver.dg_grid.shape, solver.f_dtype, 0)
    ms = time_ms(lambda: solver.op_dp.vmult(x))
    print_matvec_details("matvec:hermite", dg_matvec_model(
        3, 4, n_cells, "hermite", x.element_size(), n_dofs, ms / 1e3), n_dofs)

    require(sol.shape == solver.dg_grid.shape
            and bool(torch.isfinite(sol).all()), "DG solution not finite")
    require(abs(err - DG_L2) <= DG_L2_TOL, f"DG L2 error {err:.6e} vs {DG_L2}")
    require(DG_RATE[0] <= rate <= DG_RATE[1], f"DG rate {rate:.4e}")
    require(DG_ITS[0] <= frac_its <= DG_ITS[1], f"DG frac its {frac_its:.4f}")
    return launches, sol, err


def anchor_exact(coords):
    """prod sin(3 pi x_d), zero on the boundary of [0, 1]^3."""
    out = 1.0
    for c in coords:
        out = out * np.sin(3.0 * np.pi * c)
    return out


def anchor_rhs(coords):
    return len(coords) * (3.0 * np.pi) ** 2 * anchor_exact(coords)


def dg_plain_path(dev, card, dg_sol, dg_err) -> dict:
    """poisson_dg_plain: the size-4 solve on the card against the CPU, the
    pinned 3-D anchors, the size-48 solve (best of 3 after set-up) against
    poisson_dg's solution ``dg_sol`` and L2 error ``dg_err``, the
    variable-coefficient L2 order and one row of each DG benchmark driver;
    returns the device kernels launched by the size-48 solves and their L2
    error."""
    from multigrid_tpu_torch.experiments import (matvec_dg, matvec_dg_cheby,
                                                 solver_dg)
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.experiments.poisson_dg_plain import (
        varcoeff_coeff, varcoeff_exact, varcoeff_rhs)
    from multigrid_tpu_torch.mesh.brick import cube, poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDGPlain

    def build(mesh, where, degree=4, fns=(exact_fn, rhs_fn), **kw):
        return MultigridSolverDGPlain(mesh, degree, *fns, kind="hermite",
                                      n_pre=3, n_post=3, device=where, **kw)

    # a small solve on the card against the same solve on the CPU
    u_gpu, u_cpu = (build(poisson_cube_mesh(4), where).solve_cg(DG_RTOL)[0].cpu()
                    for where in (dev, "cpu"))
    diff = float((u_gpu - u_cpu).abs().max())
    require(diff <= 1e-5 * float(u_cpu.abs().max()),
            f"size-4 DGPlain solve on the card vs CPU: max diff {diff:.3e}")
    print(f"size-4 DGPlain solve card vs CPU: max diff {diff:.3e}")

    # the pinned anchors, on the card
    for n_ref, want in PLAIN_ANCHORS.items():
        s = build(cube(2, 0.0, 1.0, n_ref, dim=3), dev, 3,
                  (anchor_exact, anchor_rhs))
        sol, frac_its, rate = s.solve_cg(tolerance=1e-10)
        got = (frac_its, rate, s.l2_error(sol, s.exact_quad))
        print(f"DGPlain anchor n_ref {n_ref}: its {got[0]:.4f}, rate "
              f"{got[1]:.4e}, L2 {got[2]:.6e} (pinned {want})")
        for g, w, tol, what in zip(got, want, PLAIN_ANCHOR_TOL,
                                   ("its", "rate", "L2")):
            require(abs(g / w - 1) <= tol,
                    f"DGPlain anchor n_ref {n_ref}: {what} {g:.6e} vs {w}")

    # size 48 at full width
    t0 = time.perf_counter()
    solver = build(poisson_cube_mesh(DG_SIZE), dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"DGPlain setup: {setup_s:.2f} s for {solver.grids[-1].n_dofs} DG "
          f"dofs, levels {[g.cells[0] for g in solver.grids]} cells per axis, "
          f"coarse Chebyshev degree {solver.smoothers[0].degree} [{card}]")
    reset_launches()
    cg_s = []
    sol = None
    for _ in range(3):
        sol = None
        t0 = time.perf_counter()
        sol, frac_its, rate = solver.solve_cg(tolerance=DG_RTOL)
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = read_launches()
    err = solver.l2_error(sol, solver.exact_quad)
    diff = float((sol - dg_sol).abs().max()) / float(dg_sol.abs().max())
    print(f"dg-plain cg: {min(cg_s):.4f} s (runs "
          f"{', '.join(f'{s:.4f}' for s in cg_s)}), frac its {frac_its:.4f}, "
          f"rate {rate:.4e}, L2 {err:.6e} (poisson_dg {dg_err:.6e}), "
          f"max|u - u_dg| / max|u_dg| {diff:.3e} [{card}]")
    require(sol.shape == solver.grids[-1].shape
            and bool(torch.isfinite(sol).all()), "DGPlain solution not finite")
    require(abs(err / dg_err - 1) <= PLAIN_AGREE,
            f"DGPlain L2 {err:.6e} vs poisson_dg {dg_err:.6e}")
    require(diff <= PLAIN_AGREE, f"DGPlain solution vs poisson_dg: {diff:.3e}")
    require(rate < PLAIN_RATE, f"DGPlain rate {rate:.4e}")
    del solver, sol

    # variable coefficient (plain PyTorch on the card)
    errs = []
    for size in VC_SIZES:
        t0 = time.perf_counter()
        s = build(poisson_cube_mesh(size), dev, VC_DEGREE,
                  (varcoeff_exact, varcoeff_rhs), coeff_fn=varcoeff_coeff)
        sol, frac_its, rate = s.solve_cg(tolerance=1e-10)
        errs.append(s.l2_error(sol, s.exact_quad))
        print(f"var-coeff size {size}: its {frac_its:.4f}, rate {rate:.4e}, "
              f"L2 {errs[-1]:.6e}, {time.perf_counter() - t0:.2f} s with "
              f"set-up [{card}]")
        require(rate < VC_RATE, f"var-coeff size {size}: rate {rate:.4e}")
        del s, sol
    order = float(np.log2(errs[0] / errs[1]))
    print(f"var-coeff L2 order {order:.3f} (bar > {VC_DEGREE + 0.6})")
    require(order > VC_DEGREE + 0.6, f"var-coeff L2 order {order:.3f}")

    # one small row of each DG benchmark driver; each holds its result
    # against the plain version at its bar and raises on a miss
    for dtype in (torch.float64, torch.float32):
        matvec_dg.run(4, "hermite", 6, dtype, dev)
    matvec_dg_cheby.run(4, "gauss", 6, dev)
    solver_dg.run(3, "gauss", 6, 50, dev)
    return launches, err


def solver_dg_path(dev, card) -> dict:
    """solver_dg at full width (``SOLVER_DG``): the fused row on the
    kernels ``dg_cg<double>`` and ``dg_jacobi_cg<double>`` (no host sync
    inside its loop: solver_dg runs it under PyTorch's sync debug mode,
    which raises on one), the face row and the unfused row, both cell rows
    against the face row at 1e-9 (solver_dg raises on a miss); the
    launches an iteration of both cell rows; then each fused kernel timed
    on this grid beside its bound.  Returns the device kernels launched by
    the three rows."""
    from multigrid_tpu_torch.experiments import solver_dg
    from multigrid_tpu_torch.experiments.matvec_dg import bench_grid
    from multigrid_tpu_torch.ops import dg_kernel as dk
    from multigrid_tpu_torch.ops.dg_precond import JacobiTransformed
    from multigrid_tpu_torch.utils.perf_model import dg_matvec_ops

    reset_launches()
    row = solver_dg.run(**SOLVER_DG, device=dev)
    launches = read_launches()
    per_it = row["launches"]
    print(f"solver_dg {row['kind']} p={row['degree']}, {row['n_dofs']} DG "
          f"dofs, {SOLVER_DG['n_iterations']} its: fused "
          f"{row['fused_s_per_it'] * 1e3:.4f} ms/it, face (plain) "
          f"{row['face_s_per_it'] * 1e3:.4f}, unfused "
          f"{row['unfused_s_per_it'] * 1e3:.4f}; fusion speedup "
          f"{row['unfused_s_per_it'] / row['fused_s_per_it']:.3f}x; "
          f"against the face row: fused {row['verify_fused']:.2e}, unfused "
          f"{row['verify_unfused']:.2e} [{card}]")
    print(f"  launches an iteration (the first pass spread over the "
          f"iterations): fused {per_it['fused']}, unfused "
          f"{per_it['unfused']}")
    require(set(per_it["fused"]) == SOLVER_DG_FUSED,
            f"solver_dg's fused row launched {per_it['fused']}")
    # the fused kernels at this grid, one call each beside its bound
    grid = bench_grid(SOLVER_DG["degree"], SOLVER_DG["kind"],
                      SOLVER_DG["n_cell_steps"], shear=False)
    f64 = torch.float64
    op = dk.DGOperator(grid, f64, dev)
    op.install_jacobi(JacobiTransformed(grid, f64, dev))
    rng = np.random.default_rng(5)
    v = [torch.as_tensor(rng.standard_normal(grid.shape), dtype=f64,
                         device=dev) for _ in range(5)]
    p_old, z, x, r, q = v
    pp, qq = torch.empty_like(x), torch.empty_like(x)
    scal = torch.tensor([1e-3, 0.5, 1.0, 0.0, 0.0], dtype=f64, device=dev)
    partial = dk.cg_partials(grid, dev)
    n_dofs, n = grid.n_dofs, grid.n
    flops = dg_matvec_ops(3, grid.degree, int(np.prod(grid.cells)), grid.kind)
    for name, fn, nbytes, ops in (
            ("dg_cg<double>",
             lambda: dk.dg_cg(p_old, z, x, scal, pp, qq, op, partial),
             6 * 8 * n_dofs, flops + 6 * n_dofs),
            ("dg_jacobi_cg<double>",
             lambda: dk.dg_jacobi_cg(r, q, scal, qq, op, partial),
             5 * 8 * n_dofs, (12 * n + 7) * n_dofs)):
        ms = time_ms(fn)
        b_ms, by = bound(nbytes, ops, f64)
        print(f"  {name} at {n_dofs} DG dofs: {ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by}, {nbytes / 1e9:.3f} GB) [{card}]")
    return launches


def general_path(dev, card) -> dict:
    """The general-geometry path: the shell anchors, the 1,597,570-dof
    shell in mixed precision (set-up, FMG and CG best of 3, two CG
    solutions bit for bit) and in pure double, minimal_surface and
    ``poisson_cube --deform``; returns the device kernels launched by the
    mixed-precision shell solves."""
    from multigrid_tpu_torch.experiments import minimal_surface as ms
    from multigrid_tpu_torch.experiments import poisson_shell as ps
    from multigrid_tpu_torch.experiments.poisson_cube import (
        exact_fn as cube_exact, rhs_fn as cube_rhs)
    from multigrid_tpu_torch.mesh.shapes import (deformed_cube, hyper_shell,
                                                 hyper_shell_12)
    from multigrid_tpu_torch.solvers.multigrid_general import (
        GeneralMultigridSolver)

    t_path = time.perf_counter()
    meshes = {"shell6": hyper_shell, "shell12": hyper_shell_12}
    for (name, n_levels, pd), want in SHELL_ANCHORS.items():
        s = ps.build_solver(meshes[name](0.5, 1.0, n_levels=n_levels), 3,
                            pure_double=pd, device=dev)
        dofs = s.grids[s.maxlevel].n_dofs
        fmg = s.l2_error(s.maxlevel, s.solve())
        sol, its, red = s.solve_cg()
        cg = s.l2_error(s.maxlevel, sol)
        print(f"shell anchor {name} {n_levels} levels "
              f"{'pure double' if pd else 'mixed'}: {dofs} dofs, FMG L2 "
              f"{fmg:.6e}, {its} its, reduction {red:.6f}, CG L2 {cg:.6e} "
              f"(pinned {want})")
        require(dofs == want[0], f"shell anchor {name}: {dofs} dofs")
        require(its == want[2], f"shell anchor {name}: cg_its {its}")
        for got, w, tol, what in ((fmg, want[1], SHELL_ANCHOR_TOL[0], "FMG L2"),
                                  (red, want[3], SHELL_ANCHOR_TOL[1],
                                   "reduction"),
                                  (cg, want[4], SHELL_ANCHOR_TOL[2], "CG L2")):
            require(abs(got / w - 1) <= tol,
                    f"shell anchor {name} {n_levels} pd={pd}: {what} {got}")
        del s

    launches = None
    for levels, pd in ((SHELL_LEVELS, False), (PD_LEVELS, True)):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        s = ps.build_solver(ps.shell_mesh(2 * (levels - 1)), 4,
                            pure_double=pd, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        label = "pure double, fourth kind" if pd else "mixed"
        if not pd:
            reset_launches()
        row = ps.run_row(s, verbose=False)
        if not pd:
            launches = read_launches()
            sols = [s.solve_cg()[0] for _ in range(2)]
            require(torch.equal(*sols), "two CG solves differ")
            del sols
        mem = torch.cuda.max_memory_allocated(dev)
        print(f"shell {levels} levels {label}: {row['dofs']} dofs, "
              f"{row['cells']} cells, set-up {setup_s:.2f} s, FMG "
              f"{row['fmg_time']:.4f} s (L2 {row['fmg_L2error']:.6e}), CG "
              f"{row['cg_time']:.4f} s, {row['cg_its']} its, reduction "
              f"{row['cg_reduction']:.4f}, CG L2 {row['cg_L2error']:.6e}, "
              f"coarse Chebyshev degree {s.smoothers[0].degree}, "
              f"max_memory_allocated {mem} bytes [{card}]")
        if not pd:
            print(f"  launches during the mixed shell solves (3 FMG, 3 CG): "
                  f"{ {k: v for k, v in launches.items() if v} }; two CG "
                  "solves agree bit for bit")
        require(abs(row["cg_L2error"] / SHELL_CG_L2[levels] - 1)
                <= SHELL_CG_L2_TOL,
                f"shell {levels} levels {label}: CG L2 {row['cg_L2error']}")
        require(np.isfinite(row["fmg_L2error"])
                and abs(row["cg_its"] - SHELL_ITS[levels, pd]) <= 1,
                f"shell {levels} levels {label}: {row}")
        if not pd:
            require(abs(row["fmg_L2error"] / SHELL_MIXED[0] - 1)
                    <= SHELL_ANCHOR_TOL[0]
                    and abs(row["cg_reduction"] / SHELL_MIXED[1] - 1)
                    <= SHELL_ANCHOR_TOL[1],
                    f"shell {levels} levels {label}: {row}")
        del s
        torch.cuda.empty_cache()

    # minimal_surface: the card against the CPU, then one degree-4 row
    runs = {}
    for where in (dev, "cpu"):
        newton = ms.MinimalSurfaceNewton(2, 2, where)
        _, res, cg_total = newton.solve(tol=MS_TOL, max_newton=25,
                                        verbose=False)
        runs[str(where)] = (np.array(res), cg_total)
    (r_gpu, cg_gpu), (r_cpu, cg_cpu) = runs[str(dev)], runs["cpu"]
    print(f"minimal_surface 2 levels, degree 2: card {len(r_gpu) - 1} Newton "
          f"steps, {cg_gpu} CG its, |r| {r_gpu[-1]:.3e}; CPU "
          f"{len(r_cpu) - 1}, {cg_cpu}, {r_cpu[-1]:.3e}")
    require(len(r_gpu) == len(r_cpu) and cg_gpu == cg_cpu,
            "minimal_surface: the card's Newton or CG counts differ")
    diff = np.abs(r_gpu - r_cpu) / np.maximum(r_cpu, MS_TOL)
    print(f"  residual histories: max relative difference {diff.max():.3e}")
    require(diff.max() <= MS_AGREE, "minimal_surface residual histories")
    for r in ms.run_refinement_cycles(*MS_ROW, verbose=False, device=dev):
        print(f"minimal_surface degree {MS_ROW[2]}, cycle {r['cycle']}: "
              f"{r['dofs']} dofs, {r['newton_its']} Newton steps, "
              f"{r['cg_its']} CG its, final |r| {r['final_residual']:.3e}, "
              f"Newton {r['seconds']:.2f} s [{card}]")
        require(r["final_residual"] < 1e-12,
                f"minimal_surface degree 4 cycle {r['cycle']}: {r}")

    # poisson_cube --deform, degree 3
    errs, itss = [], []
    for n_levels in (2, 3):
        s = GeneralMultigridSolver(deformed_cube(2, n_levels=n_levels), 3,
                                   cube_exact, cube_rhs, device=dev)
        sol, its, red = s.solve_cg()
        errs.append(s.l2_error(s.maxlevel, sol))
        itss.append(its)
        print(f"deformed cube {n_levels} levels, degree 3: "
              f"{s.grids[s.maxlevel].n_dofs} dofs, {its} its, reduction "
              f"{red:.4f}, CG L2 {errs[-1]:.6e}")
        del s
    rate = float(np.log2(errs[0] / errs[1]))
    print(f"  deformed cube L2 rate {rate:.3f} (bar > {DEFORM_RATE}); "
          f"general path {time.perf_counter() - t_path:.1f} s")
    require(max(itss) <= DEFORM_ITS and abs(itss[0] - itss[1]) <= 1,
            f"deformed cube its {itss}")
    require(rate > DEFORM_RATE, f"deformed cube L2 rate {rate:.3f}")
    return launches


def dg_curved_path(dev, card, checks, plain_err: float) -> dict:
    """poisson_dg_plain --deform: the small rows on the card against the
    CPU and the JAX anchors, the full-width solve (set-up, best of 3 CG
    solves, rate, frac its, L2 against the affine row's ``plain_err``,
    peak memory), the CG kernels at its vector length and one matvec_dg
    --impl curved row in each precision; returns the device kernels
    launched by the full-width solves."""
    from multigrid_tpu_torch.experiments import matvec_dg
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.experiments.poisson_dg_plain import deform_chart
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDGPlain

    t_path = time.perf_counter()

    def build(size, where, degree, kind):
        mesh = poisson_cube_mesh(size)
        return MultigridSolverDGPlain(mesh, degree, exact_fn, rhs_fn,
                                      kind=kind, n_pre=3, n_post=3,
                                      device=where,
                                      mapping=deform_chart(mesh,
                                                           CURVED_FACTOR))

    for kind, anchors in CURVED_ANCHORS.items():
        for size, (a_its, a_l2) in zip((2, 4), anchors):
            got = {}
            for where in (dev, "cpu"):
                s = build(size, where, 3, kind)
                sol, its, rate = s.solve_cg(tolerance=1e-10)
                got[str(where)] = (its, s.l2_error(sol, s.exact_quad))
                del s, sol
            (its, l2), (c_its, c_l2) = got[str(dev)], got["cpu"]
            print(f"curved DG-plain {kind} {size ** 3 * 64} DG dofs p=3: "
                  f"card frac its {its:.4f}, L2 {l2:.6e}; CPU {c_its:.4f}, "
                  f"{c_l2:.6e}; JAX CPU {a_its}, {a_l2}")
            for ref_its, ref_l2, what in ((c_its, c_l2, "CPU"),
                                          (a_its, a_l2, "JAX anchor")):
                require(abs(np.ceil(its) - np.ceil(ref_its)) <= 1
                        and abs(its / ref_its - 1) <= CURVED_AGREE
                        and abs(l2 / ref_l2 - 1) <= CURVED_AGREE,
                        f"curved {kind} size {size}: card ({its}, {l2}) vs "
                        f"{what} ({ref_its}, {ref_l2})")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build(CURVED_SIZE, dev, 4, "hermite")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"curved DG-plain set-up: {setup_s:.2f} s for "
          f"{solver.grids[-1].n_dofs} DG dofs, levels "
          f"{[g.cells[0] for g in solver.grids]} cells per axis, coarse "
          f"Chebyshev degree {solver.smoothers[0].degree} [{card}]")
    require(setup_s <= CURVED_SETUP_LIMIT,
            f"curved set-up {setup_s:.1f} s at size {CURVED_SIZE}")
    reset_launches()
    cg_s = []
    sol = None
    for _ in range(3):
        sol = None
        t0 = time.perf_counter()
        sol, frac_its, rate = solver.solve_cg(tolerance=DG_RTOL)
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = read_launches()
    err = solver.l2_error(sol, solver.exact_quad)
    mem = torch.cuda.max_memory_allocated(dev)
    n_dofs = solver.grids[-1].n_dofs
    print(f"curved DG-plain cg at {n_dofs} DG dofs: "
          f"{min(cg_s):.4f} s (runs {', '.join(f'{t:.4f}' for t in cg_s)}), "
          f"frac its {frac_its:.4f}, rate {rate:.4e}, L2 {err:.9e} (affine "
          f"{plain_err:.9e}, relative difference "
          f"{abs(err / plain_err - 1):.3e}), set-up {setup_s:.2f} s, "
          f"max_memory_allocated {mem} bytes [{card}]")
    print(f"  launches during the curved solves (3 CG): "
          f"{ {k: v for k, v in launches.items() if v} }")
    require(sol.shape == solver.grids[-1].shape
            and bool(torch.isfinite(sol).all()), "curved solution not finite")
    require(rate < CURVED_RATE, f"curved DG-plain rate {rate:.4e}")
    require(abs(frac_its - CURVED_ITS) <= 1,
            f"curved DG-plain frac its {frac_its:.4f} vs {CURVED_ITS}")
    require(abs(err / plain_err - 1) <= CURVED_L2_AGREE,
            f"curved DG-plain L2 {err:.9e} vs affine {plain_err:.9e}")
    del solver, sol
    torch.cuda.empty_cache()
    # the CG kernels against their plain versions at this path's length
    checks.cg_checks(n_dofs, False)
    torch.cuda.synchronize()
    print(f"  CG kernel checks passed at {n_dofs} entries")

    # one matvec_dg --impl curved row in each precision (each holds its
    # result against the face-based operator at its bar and raises)
    for dtype in (torch.float64, torch.float32):
        matvec_dg.run(4, "hermite", 15, dtype, dev, impl="curved")
    print(f"  curved DG path {time.perf_counter() - t_path:.1f} s")
    return launches


def l_path(dev, card, checks) -> dict:
    """poisson_l: the anchor cycles on the card against the CPU on the
    card's forest, the top row past 700,000 dofs (two CG solves bit for
    bit), the 3-D cycle pair and a local-smoothing row, then the CG kernels
    against their plain versions at every length the path gave them;
    returns the device kernels launched by the path's solves."""
    from multigrid_tpu_torch.experiments import poisson_l as pl

    t_path = time.perf_counter()
    reset_launches()

    def show(label, row):
        print(f"poisson_l {label}: {row['cells']} cells, {row['dofs']} dofs, "
              f"{row['constraints']} constraints, {row['solver_its']} its, "
              f"reduction {row['reduction']:.5f}, val_L2 {row['val_L2']:.6e}, "
              f"grad_L2 {row['grad_L2']:.6e}, estimator "
              f"{row['estimator']:.6e}, set-up {row['setup_time']:.2f} s, "
              f"solve {row['solve_time']:.4f} s, max_memory_allocated "
              f"{row.get('peak_bytes', '-')} bytes [{card}]", flush=True)

    # the anchor cycles: the card's AMR loop, each forest also solved on
    # the CPU; the CPU's own loop is followed alongside to see from which
    # cycle the two refine different cells (Kelly ties round differently)
    lengths = set()
    forest = pl.l_forest(5)
    first_diff = None
    for cycle, want in enumerate(L_ANCHORS):
        row, _, eta2, _ = pl.run_cycle(forest, 2, device=dev)
        lengths.add(row["dofs"])
        c_row, _, c_eta2, _ = pl.run_cycle(forest, 2, device="cpu")
        show(f"--initial 5 cycle {cycle} (card)", row)
        print(f"  CPU on the same forest: {c_row['solver_its']} its, "
              f"reduction {c_row['reduction']:.5f}, val_L2 "
              f"{c_row['val_L2']:.6e}; JAX anchor {want}")
        require(abs(row["solver_its"] - c_row["solver_its"]) <= 1
                and abs(row["val_L2"] / c_row["val_L2"] - 1) <= L_AGREE,
                f"poisson_l cycle {cycle}: card {row} vs CPU {c_row}")
        if first_diff is None:
            require((row["dofs"], row["constraints"]) == want[:2]
                    and abs(row["solver_its"] - want[2]) <= 1
                    and abs(row["reduction"] / want[3] - 1) <= L_AGREE
                    and abs(row["val_L2"] / want[4] - 1) <= L_AGREE,
                    f"poisson_l cycle {cycle}: {row} vs anchor {want}")
        nxt = pl.refine_and_coarsen_fixed_number(forest, eta2, 0.15, 0.03)
        c_nxt = pl.refine_and_coarsen_fixed_number(forest, c_eta2, 0.15, 0.03)
        if first_diff is None and c_nxt.active != nxt.active:
            first_diff = cycle + 1
        forest = nxt
    print(f"  card and CPU Kelly marking: "
          f"{'the same meshes through cycle ' + str(len(L_ANCHORS) - 1) if first_diff is None else f'different meshes from cycle {first_diff} on'}")

    # the top rows, adaptive from --initial L_TOP_INITIAL
    forest = pl.l_forest(L_TOP_INITIAL)
    prev = None
    for k in range(len(L_TOP_ROWS)):
        row, sol, eta2, s = pl.run_cycle(forest, 2, device=dev)
        lengths.add(row["dofs"])
        if prev is not None:
            row["transfer_rel_diff"] = pl.transfer_rel_diff(s.grids[-1],
                                                            *prev, sol)
        show(f"--initial {L_TOP_INITIAL} ({len(s.grids)} levels)", row)
        its, red = L_TOP_ROWS[k]
        require(abs(row["solver_its"] - its) <= 1
                and abs(row["reduction"] / red - 1) <= L_TOP_AGREE
                and np.isfinite(row["val_L2"])
                and bool(torch.isfinite(sol).all())
                and row["dofs"] <= L_MAX_DOFS,
                f"poisson_l top row {k}: {row} vs ({its}, {red})")
        if row["dofs"] > L_TOP_DOFS:
            sols = [s.solve_cg()[0] for _ in range(2)]
            require(torch.equal(*sols) and torch.equal(sols[0], sol),
                    "two poisson_l CG solves differ")
            print(f"  three CG solves at {row['dofs']} dofs agree bit for "
                  "bit")
            break
        prev = (s.grids[-1], sol)
        del s
        forest = pl.refine_and_coarsen_fixed_number(forest, eta2, 0.15, 0.03)
    require(row["dofs"] > L_TOP_DOFS,
            f"poisson_l: no row past {L_TOP_DOFS} dofs in {len(L_TOP_ROWS)}")
    del s, sol, prev
    torch.cuda.empty_cache()

    # the 3-D extruded L, one cycle pair
    forest = pl.l_forest(3, 3)
    rows = []
    for cycle in range(2):
        row, _, eta2, _ = pl.run_cycle(forest, 2, device=dev)
        lengths.add(row["dofs"])
        show(f"--dim 3 --initial 3 cycle {cycle}", row)
        rows.append(row)
        forest = pl.refine_and_coarsen_fixed_number(forest, eta2, 0.15, 0.03)
    require(all(r["solver_its"] <= L_ITS for r in rows)
            and rows[1]["constraints"] > 0
            and rows[1]["val_L2"] < rows[0]["val_L2"],
            f"poisson_l --dim 3: {rows}")

    # the reference's preconditioner: local smoothing
    row, *_ = pl.run_cycle(pl.l_forest(L_LOCAL_INITIAL), 2,
                           local_smoothing=True, device=dev)
    show(f"--local-smoothing --initial {L_LOCAL_INITIAL}", row)
    require(row["dofs"] == L_LOCAL_DOFS and row["solver_its"] <= L_ITS,
            f"poisson_l --local-smoothing: {row}")
    launches = read_launches()
    lengths.add(row["dofs"])
    print(f"  launches during the poisson_l path: "
          f"{ {k: v for k, v in launches.items() if v} }")

    # the CG kernels against their plain versions at every solve length
    for n in sorted(lengths):
        checks.cg_checks(n, False)
    torch.cuda.synchronize()
    print(f"  CG kernel checks passed at {sorted(lengths)} entries; "
          f"poisson_l path {time.perf_counter() - t_path:.1f} s")
    return launches


def solve_rows(solver, reps: int = 2):
    """FMG and CG of a brick solver, best of ``reps`` each, the V-cycle
    reduction in between: (fmg s, cg s, FMG solution, CG solution, its, CG
    reduction, V-cycle reduction)."""
    fmg_s, cg_s = [], []
    sol = sol_cg = None
    for _ in range(reps):
        sol = None
        t0 = time.perf_counter()
        sol = solver.solve()
        torch.cuda.synchronize()
        fmg_s.append(time.perf_counter() - t0)
    _, _, reduction = solver.solve_analyze()
    for _ in range(reps):
        sol_cg = None
        t0 = time.perf_counter()
        sol_cg, its, cg_red = solver.solve_cg()
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    return min(fmg_s), min(cg_s), sol, sol_cg, its, cg_red, reduction


def cube_degree_path(dev, card, p: int, size: int) -> dict:
    """poisson_cube at degree ``p`` (8 or 9; brick_kron's new degrees) on
    ``poisson_cube_mesh(size)``: set-up, FMG and CG (best of 2), its CG its
    within one of the CPU's on the 4^3 mesh; returns the device kernels
    launched by the solves."""
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh

    small = build_solver(poisson_cube_mesh(HIGH_DEGREE_SMALL), p,
                         device="cpu")
    _, cpu_its, cpu_red = small.solve_cg()
    del small
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build_solver(poisson_cube_mesh(size), p, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g = solver.grids[solver.maxlevel]
    reset_launches()
    fmg_s, cg_s, sol, sol_cg, its, cg_red, reduction = solve_rows(solver)
    launches = read_launches()
    fmg_l2 = solver.l2_error(solver.maxlevel, sol)
    cg_l2 = solver.l2_error(solver.maxlevel, sol_cg)
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"poisson_cube p={p} size {size}: {g.n_dofs} dofs ({g.shape} "
          f"nodes), set-up {setup_s:.2f} s, FMG {fmg_s:.4f} s (L2 "
          f"{fmg_l2:.4e}, V-cycle reduction {reduction:.4e}), CG {cg_s:.4f} "
          f"s, {its} its (CPU 4^3: {cpu_its}), reduction {cg_red:.4e} (CPU "
          f"4^3: {cpu_red:.4e}), CG L2 {cg_l2:.4e}, max_memory_allocated "
          f"{mem} bytes [{card}]")
    require(abs(its - cpu_its) <= 1, f"p={p}: cg_its {its} vs CPU {cpu_its}")
    require(sol.shape == g.shape and bool(torch.isfinite(sol).all())
            and np.isfinite(fmg_l2) and cg_l2 < L2_BOUND,
            f"p={p}: FMG L2 {fmg_l2}, CG L2 {cg_l2}")
    return launches


def dg_high_path(dev, card, path: str, p: int, dg_row=None):
    """``path`` (poisson_dg or poisson_dg_plain) at degree ``p`` (8 or 9,
    the DG kernels' degrees above p = 7): the rows of 2^3 and 4^3 cells on
    the card against the CPU and the JAX rows, then the size-24 row (best
    of 2 after set-up) at the bars of DG_HIGH_*; poisson_dg_plain's also
    against ``dg_row``, poisson_dg's (solution, L2 error) at the same
    degree.  Returns the device kernels launched by the size-24 solves and
    (solution, L2 error)."""
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import (
        MultigridSolverDG, MultigridSolverDGPlain)

    t_path = time.perf_counter()
    key, plain = (path, p), path == "poisson_dg_plain"
    cls = MultigridSolverDGPlain if plain else MultigridSolverDG

    def build(size, where):
        return cls(poisson_cube_mesh(size), p, exact_fn, rhs_fn,
                   kind="hermite", n_pre=3, n_post=3, device=where)

    def row(s):
        sol, frac_its, rate = s.solve_cg(tolerance=DG_RTOL)
        return sol, (frac_its, rate, s.l2_error(sol, s.exact_quad))

    for size in DG_HIGH_SMALL:
        _, got = row(build(size, dev))
        refs = [(DG_HIGH_ANCHORS[key][size], "JAX")]
        if size in DG_HIGH_CPU_SMALL:
            refs.insert(0, (row(build(size, "cpu"))[1], "CPU"))
        print(f"{path} p={p} size {size}: its {got[0]:.4f}, rate "
              f"{got[1]:.4e}, L2 {got[2]:.6e} ("
              + "; ".join(f"{what} {ref[0]:.4f}, {ref[1]:.4e}, {ref[2]:.6e}"
                          for ref, what in refs) + ")")
        for ref, what in refs:
            require(abs(math.ceil(got[0]) - math.ceil(ref[0])) <= 1
                    and abs(got[0] / ref[0] - 1) <= DG_HIGH_AGREE
                    and abs(got[2] / ref[2] - 1) <= DG_HIGH_AGREE,
                    f"{path} p={p} size {size}: {got} vs {what} {ref}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build(DG_HIGH_SIZE, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_launches()
    cg_s = []
    sol = None
    for _ in range(2):
        sol = None
        t0 = time.perf_counter()
        sol, (frac_its, rate, err) = row(solver)
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = read_launches()
    n_dofs = sol.numel()
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"{path} p={p} size {DG_HIGH_SIZE}: {n_dofs} DG dofs, set-up "
          f"{setup_s:.2f} s, CG {min(cg_s):.4f} s (runs "
          f"{', '.join(f'{t:.4f}' for t in cg_s)}), frac its {frac_its:.4f} "
          f"(CPU size 12: {DG_HIGH_CPU[key]}), rate {rate:.4e} (band "
          f"{DG_HIGH_RATE[key]}), L2 {err:.6e}, max_memory_allocated {mem} "
          f"bytes [{card}]")
    require(bool(torch.isfinite(sol).all()), f"{path} p={p}: not finite")
    require(abs(frac_its - DG_HIGH_CPU[key]) <= 1,
            f"{path} p={p}: frac its {frac_its:.4f}")
    lo, hi = DG_HIGH_RATE[key]
    require(lo <= rate <= hi and (not plain or rate < PLAIN_RATE),
            f"{path} p={p}: rate {rate:.4e}")
    require(abs(err - DG_L2) <= DG_L2_TOL, f"{path} p={p}: L2 {err:.6e}")
    if plain:
        dg_sol, dg_err = dg_row
        diff = float((sol - dg_sol).abs().max()) / float(dg_sol.abs().max())
        print(f"  {path} p={p}: L2 {err:.6e} (poisson_dg {dg_err:.6e}), "
              f"max|u - u_dg| / max|u_dg| {diff:.3e}")
        require(abs(err / dg_err - 1) <= PLAIN_AGREE
                and diff <= PLAIN_AGREE,
                f"{path} p={p} vs poisson_dg: L2 {err:.6e} / {dg_err:.6e}, "
                f"solution {diff:.3e}")
    print(f"  {path} p={p} path {time.perf_counter() - t_path:.1f} s")
    return launches, (sol, err)


def cube_wide_path(dev, card, p: int, size: int) -> dict:
    """poisson_cube at degree ``p`` (10 or 16, brick_kron's z-slab march
    in both types): the size-2 row on the card against the JAX row
    (:data:`WIDE_ANCHORS`: CG its within one, CG L2 to WIDE_AGREE),
    then ``poisson_cube_mesh(size)``: set-up, FMG and CG (best of 2), its
    CG its within one of the size-2 row's, every level on the kernels;
    returns the device kernels launched by the full-width solves."""
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh

    small = build_solver(poisson_cube_mesh(WIDE_SMALL), p, device=dev)
    sol2, its2, red2 = small.solve_cg()
    l2_2 = small.l2_error(small.maxlevel, sol2)
    ref = WIDE_ANCHORS["poisson_cube", p][WIDE_SMALL]
    print(f"poisson_cube p={p} size {WIDE_SMALL}: {its2} its, reduction "
          f"{red2:.4e}, CG L2 {l2_2:.6e} (JAX {ref[0]}, {ref[1]:.4e}, "
          f"{ref[2]:.6e})")
    require(abs(its2 - ref[0]) <= 1 and abs(l2_2 / ref[2] - 1)
            <= WIDE_AGREE[p], f"poisson_cube p={p} size {WIDE_SMALL}: "
            f"({its2}, {red2}, {l2_2}) vs JAX {ref}")
    del small, sol2
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build_solver(poisson_cube_mesh(size), p, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    require(all(op.kron for op in solver.sp_ops + solver.dp_ops),
            f"poisson_cube p={p}: a level off the kernels")
    g = solver.grids[solver.maxlevel]
    reset_launches()
    fmg_s, cg_s, sol, sol_cg, its, cg_red, reduction = solve_rows(solver)
    launches = read_launches()
    fmg_l2 = solver.l2_error(solver.maxlevel, sol)
    cg_l2 = solver.l2_error(solver.maxlevel, sol_cg)
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"poisson_cube p={p} size {size}: {g.n_dofs} dofs ({g.shape} "
          f"nodes), set-up {setup_s:.2f} s, FMG {fmg_s:.4f} s (L2 "
          f"{fmg_l2:.4e}, V-cycle reduction {reduction:.4e}), CG {cg_s:.4f} "
          f"s, {its} its (size {WIDE_SMALL}: {its2}), reduction "
          f"{cg_red:.4e}, CG L2 {cg_l2:.4e}, max_memory_allocated {mem} "
          f"bytes [{card}]")
    require(abs(its - its2) <= 1, f"p={p}: cg_its {its} vs size "
            f"{WIDE_SMALL}: {its2}")
    require(sol.shape == g.shape and bool(torch.isfinite(sol).all())
            and np.isfinite(fmg_l2) and cg_l2 < L2_BOUND,
            f"p={p}: FMG L2 {fmg_l2}, CG L2 {cg_l2}")
    return launches


def dg_wide_path(dev, card, path: str, p: int, dg_row=None):
    """``path`` (poisson_dg or poisson_dg_plain) at degree ``p`` (10 or
    16, the DG pencils of dg_pencil_wide*.cu): the size-2 row on the card
    against the JAX row (:data:`WIDE_ANCHORS` at WIDE_AGREE), then the
    row of :data:`WIDE_DG_SIZES` (best of 2 after set-up), every DG level
    on the kernels, at the bars of :data:`WIDE_DG_CARD`;
    poisson_dg_plain's also against ``dg_row``, poisson_dg's (solution, L2
    error) at the same degree.  Returns the device kernels launched by
    the full-width solves and (solution, L2 error)."""
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import (
        MultigridSolverDG, MultigridSolverDGPlain)

    t_path = time.perf_counter()
    key, plain = (path, p), path == "poisson_dg_plain"
    cls = MultigridSolverDGPlain if plain else MultigridSolverDG

    def build(size):
        s = cls(poisson_cube_mesh(size), p, exact_fn, rhs_fn, kind="hermite",
                n_pre=3, n_post=3, device=dev)
        require(not s.plain_route, f"{path} p={p}: a plain DG level")
        return s

    def row(s):
        sol, frac_its, rate = s.solve_cg(tolerance=DG_RTOL)
        return sol, (frac_its, rate, s.l2_error(sol, s.exact_quad))

    _, got = row(build(WIDE_SMALL))
    ref = WIDE_ANCHORS[key][WIDE_SMALL]
    print(f"{path} p={p} size {WIDE_SMALL}: its {got[0]:.4f}, rate "
          f"{got[1]:.4e}, L2 {got[2]:.6e} (JAX {ref[0]:.4f}, {ref[1]:.4e}, "
          f"{ref[2]:.6e})")
    require(abs(math.ceil(got[0]) - math.ceil(ref[0])) <= 1
            and abs(got[0] / ref[0] - 1) <= WIDE_AGREE[p]
            and abs(got[2] / ref[2] - 1) <= WIDE_AGREE[p],
            f"{path} p={p} size {WIDE_SMALL}: {got} vs JAX {ref}")
    size = WIDE_DG_SIZES[p]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build(size)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_launches()
    cg_s = []
    sol = None
    for _ in range(2):
        sol = None
        t0 = time.perf_counter()
        sol, (frac_its, rate, err) = row(solver)
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = read_launches()
    mem = torch.cuda.max_memory_allocated(dev)
    card_its, card_rate = WIDE_DG_CARD[key]
    print(f"{path} p={p} size {size}: {sol.numel()} DG dofs, set-up "
          f"{setup_s:.2f} s, CG {min(cg_s):.4f} s (runs "
          f"{', '.join(f'{t:.4f}' for t in cg_s)}), frac its {frac_its:.4f} "
          f"(first card run {card_its}), rate {rate:.4e} ({card_rate}), L2 "
          f"{err:.6e}, max_memory_allocated {mem} bytes [{card}]")
    require(bool(torch.isfinite(sol).all()), f"{path} p={p}: not finite")
    require(abs(frac_its - card_its) <= 1,
            f"{path} p={p}: frac its {frac_its:.4f}")
    require(card_rate / 2 <= rate <= 2 * card_rate,
            f"{path} p={p}: rate {rate:.4e}")
    require(abs(err - DG_L2) <= DG_L2_TOL, f"{path} p={p}: L2 {err:.6e}")
    if plain:
        dg_sol, dg_err = dg_row
        diff = float((sol - dg_sol).abs().max()) / float(dg_sol.abs().max())
        print(f"  {path} p={p}: L2 {err:.6e} (poisson_dg {dg_err:.6e}), "
              f"max|u - u_dg| / max|u_dg| {diff:.3e}")
        require(abs(err / dg_err - 1) <= PLAIN_AGREE
                and diff <= PLAIN_AGREE,
                f"{path} p={p} vs poisson_dg: L2 {err:.6e} / {dg_err:.6e}, "
                f"solution {diff:.3e}")
    print(f"  {path} p={p} path {time.perf_counter() - t_path:.1f} s")
    return launches, (sol, err)


def dg_plain_2d_path(dev, card) -> tuple[dict, dict]:
    """2-D poisson_dg_plain (the reference program's setting, p = 3): the
    small rows of every kind on the card against the CPU, then the two
    full-width hermite rows; returns the device kernels launched by the
    full-width solves (the CG kernels only: the 2-D levels are plain) and
    the top row (:func:`dg_2d_ref`), the one-device row of the 2-D
    DG-plain rank rows."""
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDGPlain

    t_path = time.perf_counter()

    def build(size, where, kind):
        return MultigridSolverDGPlain(poisson_cube_mesh(size, 2), DG2_DEGREE,
                                      exact_fn, rhs_fn, kind=kind, n_pre=3,
                                      n_post=3, device=where)

    for kind in ("hermite", "gll", "gauss"):
        for size in DG2_SMALL:
            got = {}
            for where in (dev, "cpu"):
                s = build(size, where, kind)
                require(s.plain_route, "2-D DG-plain levels not plain")
                sol, its, rate = s.solve_cg(tolerance=DG_RTOL)
                got[str(where)] = (its, rate, s.l2_error(sol, s.exact_quad))
                del s, sol
            (its, rate, l2), (c_its, c_rate, c_l2) = got[str(dev)], got["cpu"]
            print(f"2-D DG-plain (plain) {kind} {(8 * size) ** 2 * 16} DG dofs "
                  f"p={DG2_DEGREE}: card frac its {its:.4f}, rate {rate:.4e},"
                  f" L2 {l2:.6e}; CPU {c_its:.4f}, {c_rate:.4e}, {c_l2:.6e}")
            require(abs(np.ceil(its) - np.ceil(c_its)) <= 1
                    and abs(its / c_its - 1) <= DG2_AGREE
                    and abs(l2 / c_l2 - 1) <= DG2_AGREE,
                    f"2-D DG-plain {kind} size {size}: card ({its}, {l2}) vs "
                    f"CPU ({c_its}, {c_l2})")
    launches = {k: 0 for k in read_launches()}
    its_rows = []
    for size in DG2_LARGE:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        s = build(size, dev, "hermite")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_launches()
        cg_s = []
        sol = None
        for _ in range(2):
            sol = None
            t0 = time.perf_counter()
            sol, its, rate = s.solve_cg(tolerance=DG_RTOL)
            torch.cuda.synchronize()
            cg_s.append(time.perf_counter() - t0)
        for k, v in read_launches().items():
            launches[k] += v
        err = s.l2_error(sol, s.exact_quad)
        mem = torch.cuda.max_memory_allocated(dev)
        print(f"2-D DG-plain (plain) hermite size {size}: "
              f"{s.grids[-1].n_dofs} DG dofs, {len(s.grids)} levels, set-up "
              f"{setup_s:.2f} s, CG {min(cg_s):.4f} s (runs "
              f"{', '.join(f'{t:.4f}' for t in cg_s)}), frac its {its:.4f}, "
              f"rate {rate:.4e}, L2 {err:.6e}, max_memory_allocated {mem} "
              f"bytes [{card}]")
        require(sol.shape == s.grids[-1].shape
                and bool(torch.isfinite(sol).all()) and rate < PLAIN_RATE,
                f"2-D DG-plain size {size}: rate {rate:.4e}")
        its_rows.append(its)
        if size == DG2_LARGE[-1]:
            ref = dg_2d_ref("dg-plain", size, sol, its, rate, err, min(cg_s))
        del s, sol
        torch.cuda.empty_cache()
    require(abs(its_rows[1] - its_rows[0]) <= 1,
            f"2-D DG-plain full-width frac its {its_rows}")
    print(f"  2-D DG-plain path {time.perf_counter() - t_path:.1f} s")
    return launches, ref


def dg_2d_ref(path: str, size: int, sol, its, rate, err, cg_s) -> dict:
    """A one-device 2-D DG row as the rank rows read it
    (``time_ranks.one_device_dg``'s keys), its CG solution saved under
    ``SCRATCH`` (``file``)."""
    SCRATCH.mkdir(parents=True, exist_ok=True)
    f = SCRATCH / f"{path}{size}_2d_cg.npy"
    np.save(f, sol.cpu().numpy())
    return dict(frac_its=its, rate=rate, L2=err, cg_time=cg_s,
                dg_dofs=sol.numel(), file=f)


def matvec_rows_path(dev) -> dict:
    """matvec_dg in f64 at p = 8, 10, 16 (the kernel rows,
    dg_apply<double>) and above the DG kernels' degree (the "(plain)" row
    at p = 17), each verified by the experiment against the face-based
    operator at its bar (it raises on a miss); returns the device kernels
    launched by each kernel row (path ``matvec_dg_p<p>``) and by the plain
    rows (``matvec_dg_plain``: none)."""
    from multigrid_tpu_torch.experiments import matvec_dg

    launches = {}
    for rows, route in ((MATVEC_KERNEL, "kernel"), (MATVEC_PLAIN, "plain")):
        for p, steps in rows.items():
            reset_launches()
            row = matvec_dg.run(p, "hermite", steps, torch.float64, dev)
            require(row["route"] == route and row["verify"]
                    < matvec_dg.VERIFY_TOL[torch.float64],
                    f"matvec_dg p={p}: {row}")
            path = (degree_path(p, "matvec_dg") if route == "kernel"
                    else "matvec_dg_plain")
            got = read_launches()
            launches[path] = {k: launches.get(path, {}).get(k, 0) + v
                              for k, v in got.items()}
    return launches


def cube_2d_path(dev, card):
    """poisson_cube --dim 2: size 4 on the card against the CPU, then size
    64 (512^2 cells, 4,198,401 dofs): its and reductions; returns the
    device kernels launched by the size-64 solves and the size-64 row (its
    CG solution saved for the rank path)."""
    from multigrid_tpu_torch.experiments.poisson_cube import build_solver
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh

    rows = {}
    for where in (dev, "cpu"):
        s = build_solver(poisson_cube_mesh(CUBE2_SMALL, 2), 4, device=where)
        _, _, red = s.solve_analyze()
        _, its, cg_red = s.solve_cg()
        rows[str(where)] = (its, cg_red, red)
    (its, cg_red, red), (c_its, c_cg_red, c_red) = rows[str(dev)], rows["cpu"]
    print(f"2-D cube (plain) size {CUBE2_SMALL}: card {its} its, CG reduction "
          f"{cg_red:.4e}, V-cycle {red:.4e}; CPU {c_its}, {c_cg_red:.4e}, "
          f"{c_red:.4e}")
    require(its == c_its and abs(cg_red / c_cg_red - 1) <= 0.02
            and abs(red / c_red - 1) <= 0.02, "2-D cube card vs CPU")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build_solver(poisson_cube_mesh(CUBE2_SIZE, 2), 4, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g = solver.grids[solver.maxlevel]
    reset_launches()
    fmg_s, cg_s, sol, sol_cg, its, cg_red, reduction = solve_rows(solver)
    launches = read_launches()
    fmg_l2 = solver.l2_error(solver.maxlevel, sol)
    cg_l2 = solver.l2_error(solver.maxlevel, sol_cg)
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"2-D cube (plain) size {CUBE2_SIZE}: {g.n_dofs} dofs, set-up "
          f"{setup_s:.2f} s, FMG {fmg_s:.4f} s (L2 {fmg_l2:.4e}, V-cycle "
          f"reduction {reduction:.4e}), CG {cg_s:.4f} s, {its} its, "
          f"reduction {cg_red:.4e}, CG L2 {cg_l2:.4e}, max_memory_allocated "
          f"{mem} bytes [{card}]")
    require(its == CG_ITS
            and abs(cg_red / CUBE2_CG_REDUCTION - 1) <= ROW_TOL
            and abs(reduction / CUBE2_VCYCLE_REDUCTION - 1) <= ROW_TOL,
            f"2-D cube size {CUBE2_SIZE}: {its} its, {cg_red}, {reduction}")
    require(np.isfinite(fmg_l2) and cg_l2 < L2_BOUND,
            f"2-D cube L2 {fmg_l2}, {cg_l2}")
    SCRATCH.mkdir(parents=True, exist_ok=True)
    cg_file = SCRATCH / f"cube2d{CUBE2_SIZE}_cg.npy"
    np.save(cg_file, sol_cg.cpu().numpy())
    return launches, dict(reduction=reduction, cg_reduction=cg_red,
                          fmg_L2error=fmg_l2, cg_its=its, cg_file=cg_file)


def dg_2d_path(dev, card) -> tuple[dict, dict]:
    """poisson_dg --dim 2 (hermite p = 4, n_pre 3, rtol 1e-9): size 2 on
    the card against the CPU, then size 40 (2,560,000 DG dofs); returns
    the device kernels launched by the size-40 solves and that row
    (:func:`dg_2d_ref`), the one-device row of the 2-D DG rank rows."""
    from multigrid_tpu_torch.experiments.poisson_cube import exact_fn, rhs_fn
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.solvers.multigrid_dg import MultigridSolverDG

    def build(size, where):
        return MultigridSolverDG(poisson_cube_mesh(size, 2), 4, exact_fn,
                                 rhs_fn, kind="hermite", n_pre=3, n_post=3,
                                 device=where)

    got = {}
    for where in (dev, "cpu"):
        s = build(DG2D_SMALL, where)
        sol, its, rate = s.solve_cg(tolerance=DG_RTOL)
        got[str(where)] = (its, rate, s.l2_error(sol, s.exact_quad))
    (its, rate, l2), (c_its, c_rate, c_l2) = got[str(dev)], got["cpu"]
    print(f"2-D DG (plain) size {DG2D_SMALL}: card frac its {its:.4f}, rate "
          f"{rate:.4e}, L2 {l2:.6e}; CPU {c_its:.4f}, {c_rate:.4e}, "
          f"{c_l2:.6e}")
    require(abs(its / c_its - 1) <= 0.02 and abs(rate / c_rate - 1) <= 0.02
            and abs(l2 / c_l2 - 1) <= 1e-6, "2-D DG card vs CPU")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    s = build(DG2D_SIZE, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    require(s.plain_route, "2-D DG level not plain")
    reset_launches()
    cg_s = []
    sol = None
    for _ in range(2):
        sol = None
        t0 = time.perf_counter()
        sol, its, rate = s.solve_cg(tolerance=DG_RTOL)
        torch.cuda.synchronize()
        cg_s.append(time.perf_counter() - t0)
    launches = read_launches()
    err = s.l2_error(sol, s.exact_quad)
    mem = torch.cuda.max_memory_allocated(dev)
    print(f"2-D DG (plain) size {DG2D_SIZE}: {s.dg_grid.n_dofs} DG dofs, "
          f"set-up {setup_s:.2f} s, CG {min(cg_s):.4f} s (runs "
          f"{', '.join(f'{t:.4f}' for t in cg_s)}), frac its {its:.4f}, rate "
          f"{rate:.4e}, L2 {err:.6e}, max_memory_allocated {mem} bytes "
          f"[{card}]")
    require(DG_ITS[0] <= its <= DG_ITS[1] and DG_RATE[0] <= rate <= DG_RATE[1]
            and abs(err - DG2D_L2) <= DG_L2_TOL,
            f"2-D DG size {DG2D_SIZE}: {its}, {rate}, {err}")
    return launches, dg_2d_ref("dg", DG2D_SIZE, sol, its, rate, err,
                               min(cg_s))


def utils_path(dev, card):
    """The single-device utils: ``poisson_cube --output`` (2-D size 4)
    read back; the memory report after the 135M cube's set-up; one CG
    solve, its solution through a checkpoint file and back bit for bit;
    then FMG and the V-cycle reduction; returns the device kernels
    launched by the CG solve and the row (its CG solution in a file)."""
    from multigrid_tpu_torch.experiments.poisson_cube import (build_solver,
                                                              exact_fn,
                                                              run_cycle)
    from multigrid_tpu_torch.mesh.brick import DofGrid, poisson_cube_mesh
    from multigrid_tpu_torch.utils import checkpoint, memory

    scratch = SCRATCH
    scratch.mkdir(parents=True, exist_ok=True)
    mesh = poisson_cube_mesh(VTK_SIZE, 2)
    row = run_cycle(mesh, 4, 2, 2, 2, device=dev, n_fmg_repeat=1,
                    n_cg_repeat=1, n_matvec=2, verbose=False,
                    output_dir=str(scratch))
    g = DofGrid(mesh, mesh.max_level, 4)
    path = scratch / f"solution_{g.n_dofs}.vtr"
    text = path.read_text()
    fields = {}
    for name in ("solution", "error"):
        body = text.split(f'Name="{name}" format="ascii">')[1].split("<")[0]
        fields[name] = np.array(body.split(), np.float64).reshape(g.shape)
    exact = np.broadcast_to(exact_fn(g.node_coords()), g.shape)
    werr = float(np.abs(fields["solution"] - exact - fields["error"]).max())
    print(f"--output: {path.name}, {path.stat().st_size} bytes, solution - "
          f"exact - error {werr:.2e}, max|error| "
          f"{np.abs(fields['error']).max():.3e} (FMG L2 "
          f"{row['fmg_L2error']:.3e})")
    require(werr <= 1e-15 and 0 < np.abs(fields["error"]).max()
            < 20 * row["fmg_L2error"], "poisson_cube --output read back")
    path.unlink()

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = build_solver(poisson_cube_mesh(MEM_SIZE), 4, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"135M cube set-up {setup_s:.2f} s [{card}]")
    rep = memory.print_memory_report(solver)
    peak = rep["allocator"]["peak_bytes_in_use"]
    print(f"  memory report: levels {rep['total_bytes']} bytes, allocator "
          f"peak {peak} bytes, in use {rep['allocator']['bytes_in_use']}, "
          f"limit {rep['allocator']['bytes_limit']} [{card}]")
    require(peak >= rep["total_bytes"] > 0, "memory report: peak < levels")
    reset_launches()
    t0 = time.perf_counter()
    sol, its, red = solver.solve_cg()
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    launches = read_launches()
    require(its == CG_ITS, f"135M cube: {its} its")
    ck = scratch / "cg_solution.npz"
    t0 = time.perf_counter()
    checkpoint.save_state(str(ck), {"cg": {"x": sol}},
                          {"its": its, "reduction": red})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, meta = checkpoint.load_state(str(ck))
    back = torch.as_tensor(state["cg/x"], device=dev)
    load_s = time.perf_counter() - t0
    same = bool(torch.equal(back, sol))
    print(f"  135M CG: {its} its, {cg_s:.4f} s; checkpoint "
          f"{ck.stat().st_size} bytes, save {save_s:.2f} s, load {load_s:.2f}"
          f" s, bit for bit {same} [{card}]")
    require(same and meta["its"] == its, "checkpoint round trip differs")
    ck.unlink()
    del back, state
    # the single-device row the rank path is held to: FMG, its L2 error,
    # the V-cycle reduction; the CG solution in a file
    cg_file = scratch / f"cube{MEM_SIZE}_cg.npy"
    np.save(cg_file, sol.cpu().numpy())
    del sol
    t0 = time.perf_counter()
    fmg = solver.solve()
    torch.cuda.synchronize()
    fmg_s = time.perf_counter() - t0
    _, _, reduction = solver.solve_analyze()
    fmg_l2 = solver.l2_error(solver.maxlevel, fmg)
    print(f"  135M FMG: {fmg_s:.4f} s, L2 {fmg_l2:.4e}, V-cycle reduction "
          f"{reduction:.4e}; CG reduction {red:.4e} [{card}]")
    del solver, fmg
    return launches, dict(reduction=reduction, cg_reduction=red,
                          fmg_L2error=fmg_l2, cg_its=its, cg_file=cg_file)


def ranks_row(out: dict, ref: dict, n: int, grid, dim: int, size: int,
              card: str) -> None:
    """Print one poisson_cube rank row (``cube_program``'s output) and hold
    it to the single-device row ``ref`` of this run; removes the saved
    one-device CG solution."""
    from multigrid_tpu_torch.experiments import time_ranks

    label = (f"{n} ranks ({'x'.join(map(str, grid))}, gloo, one card), "
             f"{dim}-D size {size}, {out['dofs']} dofs")
    print(f"{label}: levels split {out['levels']}, finest cuts "
          f"{out['bounds'][-1]}")
    print(f"  set-up {out['setup_time']:.2f} s, FMG {out['fmg_time']:.4f}"
          f" s (runs {', '.join(f'{t:.4f}' for t in out['fmg_times'])}),"
          f" CG {out['cg_time']:.4f} s (runs "
          f"{', '.join(f'{t:.4f}' for t in out['cg_times'])}), peak "
          f"device memory of a rank {int(out['peak_bytes'])} bytes [{card}]")
    print(f"  FMG L2 {out['fmg_L2error']:.4e} (one device "
          f"{ref['fmg_L2error']:.4e}), V-cycle reduction "
          f"{out['reduction']:.4e} ({ref['reduction']:.4e}), CG "
          f"{out['cg_its']} its, reduction {out['cg_reduction']:.4e} "
          f"({ref['cg_reduction']:.4e}), CG L2 {out['cg_L2error']:.4e}")
    print(f"  CG solution against one device's: max diff "
          f"{out['cg_ref_diff']:.3e}, max|u| {out['cg_ref_max']:.4e}, "
          f"bar {RANKS_SOL_BAR:g} * max|u|; two CG solves bit for bit "
          f"{out['cg_repeat_equal']}")
    if dim == 3:
        comm = out["comm"]
        print(f"  f64 vmult of the finest level, apply then refresh: "
              f"{comm['total'] * 1e3:.3f} ms with the ghost refresh, "
              f"{comm['cell_loop'] * 1e3:.3f} ms without; exchange "
              f"share {comm['comm_fraction']:.3f}; rank 0's refresh: "
              + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                          comm["steps"].items())
              + f"; bytes a refresh by stage {comm['bytes_by_stage']} "
              f"[{card}]")
        print(f"  f64 vmult of the finest level, overlap schedule: "
              f"{time_ranks.split_line(comm)} [{card}]")
        require(comm["overlap"] is not None and comm["overlap"]["equal"],
                f"{label}: the overlap schedule of the finest level does "
                "not run or is not apply-then-refresh's bits")
        for k, v in out["apply"].items():
            print(f"  distributed {k} on the owned nodes vs BrickLaplace "
                  f"on the whole grid: bit for bit {v['equal']}, max diff "
                  f"{v['max_diff']:.3e} (max|y| {v['scale']:.3e})")
        require(all(v["equal"] for v in out["apply"].values()),
                f"{label}: the owned nodes of the apply differ")
    require(out["cg_its"] == CG_ITS, f"{label}: cg_its {out['cg_its']}")
    for key in ("cg_reduction", "reduction", "fmg_L2error"):
        require(abs(out[key] / ref[key] - 1) <= ROW_TOL,
                f"{label}: {key} {out[key]:.4e} vs {ref[key]:.4e}")
    require(out["cg_ref_diff"] <= RANKS_SOL_BAR * out["cg_ref_max"],
            f"{label}: CG solution off by {out['cg_ref_diff']:.3e}")
    require(out["cg_repeat_equal"], f"{label}: CG solves differ")
    require(any(out["levels"]) and not all(out["levels"]),
            f"{label}: no level split or none replicated")
    require(tuple(out["grid"]) == grid, f"{label}: grid {out['grid']}")
    ref["cg_file"].unlink()


def form_check(dev, card) -> None:
    """The overlap schedule where its sub-boxes run another form of
    ``brick_kron``: p = 8, float32, 20 x 16 x 16 cells cut for 2 z ranks.
    The whole grid (5120 cells) and each rank's box (3072) take the layer
    march, the sub-boxes (at most 2304 cells) the cell form
    (``laplace_kernel.brick_form``); each rank's split ``vmult``, with no
    traffic (the owned nodes need none), against the whole grid's and the
    box's, bit for bit.  One process; its launches are not a path's."""
    from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid
    from multigrid_tpu_torch.ops import laplace_kernel as lk
    from multigrid_tpu_torch.parallel.halo import (SplitApply, Slabs,
                                                   split_cells)
    from multigrid_tpu_torch.parallel.sharding import Ranks

    f32 = torch.float32
    g = DofGrid(BrickMesh((20, 16, 16), (0.0,) * 3, (1.0,) * 3), 0, 8)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(g.shape),
                        dtype=f32, device=dev)
    want = lk.BrickLaplace(g, f32, dev).vmult(x)
    require(lk.brick_form(g.shape, 8, f32) == "layer",
            "the p = 8 form check's whole grid is not on the layer march")
    for r in range(2):
        s = Slabs(g, Ranks(2, r, dev, "gloo"), split_cells(g.cells[0], 2))
        op = lk.BrickLaplace(s.local, f32, dev)
        sp = SplitApply(op, s)
        forms = [lk.brick_form(o.shape, 8, f32) for o in sp.ops]
        box_form = lk.brick_form(op.shape, 8, f32)
        xs = x[s.stored_index()].contiguous()
        got = s.own(sp.run(xs, comm=False))
        same = dict(whole_grid=torch.equal(got, want[s.owned_index()]),
                    box=torch.equal(got, s.own(op.vmult(xs))))
        print(f"  p = 8 f32 split vmult on rank {r} of 2 ({s.shape} box, "
              f"{box_form}; sub-boxes {[o.shape for o in sp.ops]}, "
              f"{forms}): owned nodes bit for bit {same}")
        require(box_form == "layer" and "cell" in forms,
                "the p = 8 form check does not mix the forms")
        require(all(same.values()),
                f"the p = 8 f32 split differs on rank {r}: {same}")


def sym_coef_check(dev, card) -> None:
    """``LaplaceOperator`` with a ``SymCoef`` on the card, 3 x 2 x 3 cells
    at p = 4: the tensor that holds the affine diagonal against the
    ``DiagCoef`` operator (``vmult`` to 1e-11 of max|y|, the inverse
    diagonal to 1e-11 relative), a random symmetric positive-definite one
    against the same operator on the CPU (1e-12 of the largest value)."""
    from multigrid_tpu_torch.mesh.brick import BrickMesh, DofGrid
    from multigrid_tpu_torch.ops.laplace import (LaplaceOperator, SymCoef,
                                                 make_diag_coef,
                                                 sym_components)

    f64 = torch.float64
    g = DofGrid(BrickMesh((3, 2, 3), (-0.3,) * 3, (1.1, 0.8, 1.3)), 0, 4)
    nq, nsym = g.degree + 1, len(sym_components(3))
    w = g.basis.quad_weights
    wq = np.multiply.outer(np.multiply.outer(w, w), w)
    C = np.zeros(tuple(g.cells) + (nq,) * 3 + (nsym,))
    diag = make_diag_coef(g)
    for d in range(3):
        C[..., d] = diag.values[d] * wq
    rng = np.random.default_rng(9)
    m = rng.standard_normal(tuple(g.cells) + (nq,) * 3 + (3, 3))
    t = m @ np.swapaxes(m, -1, -2) + 3 * np.eye(3)
    R = np.stack([t[..., a, c] for a, c in sym_components(3)], axis=-1)
    x = torch.as_tensor(rng.standard_normal(g.shape), dtype=f64)
    ops = {k: LaplaceOperator(g, f64, c, dev) for k, c in
           (("diag", diag), ("sym", SymCoef(C)), ("random", SymCoef(R)))}
    y = {k: op.vmult(x.to(dev)).cpu() for k, op in ops.items()}
    inv = {k: op.inverse_diagonal().cpu() for k, op in ops.items()}
    cpu = LaplaceOperator(g, f64, SymCoef(R), "cpu")
    errs = dict(
        vmult_vs_diag=float((y["sym"] - y["diag"]).abs().max()
                            / y["diag"].abs().max()),
        inv_diag_vs_diag=float(((inv["sym"] - inv["diag"])
                                / inv["diag"]).abs().max()),
        random_vmult_vs_cpu=float((y["random"] - cpu.vmult(x)).abs().max()
                                  / y["random"].abs().max()),
        random_inv_diag_vs_cpu=float(
            (inv["random"] - cpu.inverse_diagonal()).abs().max()
            / inv["random"].abs().max()))
    print(f"SymCoef on the card, {g.cells} cells, p = {g.degree}: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" [{card}]")
    require(errs["vmult_vs_diag"] <= 1e-11
            and errs["inv_diag_vs_diag"] <= 1e-11,
            f"the SymCoef operator is not the DiagCoef one: {errs}")
    require(errs["random_vmult_vs_cpu"] <= 1e-12
            and errs["random_inv_diag_vs_cpu"] <= 1e-12,
            f"the SymCoef operator on the card is not the CPU's: {errs}")


def dg_ranks_row(out: dict, ref: dict, path: str, n: int, grid, size: int,
                 dg_err: float, card: str, dim: int = 3) -> None:
    """Print one DG rank row (``dg_program``'s output) and hold it to its
    one-device row ``ref`` of this run and to the DG guards (a 2-D row: to
    those of its one-device 2-D path, on the plain route)."""
    from multigrid_tpu_torch.experiments import time_ranks

    label = (f"{path}{' (2-D)' if dim == 2 else ''} on {n} ranks "
             f"({'x'.join(map(str, grid))}, gloo, one card), size {size}, "
             f"{out['dg_dofs']} DG dofs")
    print(f"{label}: levels split {out['levels']}, finest cuts "
          f"{out['bounds']}")
    print(f"  set-up {out['setup_time']:.2f} s, CG {out['cg_time']:.4f} s"
          f" (runs {', '.join(f'{t:.4f}' for t in out['cg_times'])}; one "
          f"device {ref['cg_time']:.4f}), peak device memory of a rank "
          f"{int(out['peak_bytes'])} bytes [{card}]")
    print(f"  frac its {out['frac_its']:.6f} (one device "
          f"{ref['frac_its']:.6f}), rate {out['rate']:.6e} "
          f"({ref['rate']:.6e}), L2 {out['L2']:.9e} ({ref['L2']:.9e})")
    print(f"  CG solution against one device's: max diff "
          f"{out['cg_ref_diff']:.3e}, max|u| {out['cg_ref_max']:.4e}, bar "
          f"{RANKS_SOL_BAR:g} * max|u|; two CG solves bit for bit "
          f"{out['cg_repeat_equal']}")
    for k, v in out["apply"].items():
        print(f"  slab {k} on the owned cells vs the whole grid: bit for "
              f"bit {v['equal']}, max diff {v['max_diff']:.3e} (max|y| "
              f"{v['scale']:.3e})")
    for wire, comm in out["comm"].items():
        print(f"  f32 apply of the finest level, {wire} wire: "
              f"{time_ranks.comm_line(comm)} [{card}]")
    require(time_ranks.dg_row_ok(out, ref), f"{label}: off its one-device row")
    require(tuple(out["grid"]) == grid, f"{label}: grid {out['grid']}")
    require(out["plain_route"] == (dim == 2), f"{label}: plain route "
            f"{out['plain_route']}")
    if dim == 2:
        require(out["rate"] < PLAIN_RATE if path == "dg-plain" else
                DG_ITS[0] <= out["frac_its"] <= DG_ITS[1]
                and DG_RATE[0] <= out["rate"] <= DG_RATE[1]
                and abs(out["L2"] - DG2D_L2) <= DG_L2_TOL,
                f"{label}: outside its one-device path's guard")
    elif path == "dg" and len(grid) == 2:
        # the FE_Q hierarchy on the rank grid: all but the coarsest two
        # levels split
        fe = out["levels"][1:]
        require(out["levels"][0] and fe == [False, False]
                + [True] * (len(fe) - 2),
                f"{label}: levels split {out['levels']}")
    elif path == "dg":
        require(DG_ITS[0] <= out["frac_its"] <= DG_ITS[1]
                and DG_RATE[0] <= out["rate"] <= DG_RATE[1]
                and abs(out["L2"] - DG_L2) <= DG_L2_TOL,
                f"{label}: outside the DG guard")
    else:
        require(abs(out["L2"] / dg_err - 1) <= PLAIN_AGREE
                and out["rate"] < PLAIN_RATE,
                f"{label}: L2 {out['L2']:.9e} vs poisson_dg "
                f"{dg_err:.9e}, rate {out['rate']:.4e}")
    require(any(out["levels"]), f"{label}: no level split")


def halo_row(outs, halo_grid, grid, card: str) -> None:
    """Print and check ``HaloDGLaplace2D`` on the rank grid ``grid``, both
    wires (``dg_halo_program``'s output)."""
    from multigrid_tpu_torch.experiments import time_ranks

    print(f"HaloDGLaplace2D on {' x '.join(map(str, grid))} ranks, "
          f"{halo_grid.n_dofs} DG dofs (gauss p = 4)")
    for wire, out in zip(("traces", "hermite"), outs):
        w, pl = out["vmult_whole"], out["vmult_plain_whole"]
        print(f"  {wire} wire: owned cells vs DGOperator on the whole grid: "
              f"bit for bit {w['equal']}, max diff {w['max_diff']:.3e}; the "
              f"plain algorithm {pl['max_diff']:.3e} (max|y| {w['scale']:.3e})"
              f"; f64 apply {time_ranks.comm_line(out['comm'])} [{card}]")
        bar = 0.0 if wire == "traces" else DG_HERMITE_BAR * w["scale"]
        require(w["max_diff"] <= bar and pl["max_diff"]
                <= DG_HERMITE_BAR * pl["scale"],
                f"HaloDGLaplace2D {wire} wire: off the whole grid")


def rank_paths(dev, card, rows, dg_err: float,
               dg2_refs: dict) -> tuple[dict, dict, dict]:
    """poisson_cube and the DG solvers on ranks of torch.distributed
    sharing the card (gloo, the planes and cell layers staged through
    pinned host memory), one launch a world size, so that the ranks'
    start is paid once for both solvers, and one rank on nccl:

    * poisson_cube: 2 z-slab ranks at size 128, then a 2 x 2 grid at size
      64 and a 2-D 2 x 2 grid at size 64 (``RANKS_RUNS``), against the
      single-device rows of this run (``rows``: (dim, cube size) -> that
      row); the owned nodes of the distributed 3-D apply (corners
      included) against ``BrickLaplace`` on the whole grid; one rank on
      nccl against the single-device solver's bits;
    * the DG solvers: each run of ``DG_RANKS_RUNS`` against its one-device
      row of this run (``experiments/time_ranks.py``'s rows and bars),
      with the slab kernels' owned cells and the exchange split by wire;
      HaloDGLaplace2D on 2 x 2 ranks against the whole grid; one nccl rank
      of each solver against the single-device bits.  ``dg_err``:
      poisson_dg's L2 error at size 48 in this run (the DG-plain guard);
    * the 2-D DG solvers (``DG2_RANKS_RUNS``, the plain route) in both
      launches, each against its one-device 2-D row of this run
      (``dg2_refs``: path -> :func:`dg_2d_ref`).

    Each program zeroes the kernels' counts before its solves and reads
    them after.  Returns the device kernels launched by the cube solves,
    by the 3-D DG solves and by the 2-D DG solves, each summed over the
    ranks.  (A gloo send of a
    CUDA tensor aborts the sender: whence the staging.)"""
    from multigrid_tpu_torch.experiments import time_ranks
    from multigrid_tpu_torch.mesh.brick import poisson_cube_mesh
    from multigrid_tpu_torch.parallel.programs import (cube_program,
                                                       dg_halo_program,
                                                       dg_program, dg_programs,
                                                       programs)
    from multigrid_tpu_torch.parallel.sharding import launch
    from multigrid_tpu_torch.solvers.multigrid_dg import dg_grid_from_mesh

    SCRATCH.mkdir(parents=True, exist_ok=True)
    cube_total, dg_total, dg2_total = {}, {}, {}

    def add(total, launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    form_check(dev, card)
    # the ('z', 'y') split of the DG operator at full width, both wires, in
    # the 2 x 2 launch
    mesh = poisson_cube_mesh(DG_RANKS_2D)
    halo_grid = dg_grid_from_mesh(mesh, mesh.max_level, 4, "gauss")
    for (n, grid, runs), (dg_n, dg_grid_shape, dg_runs) in zip(
            RANKS_RUNS, DG_RANKS_RUNS):
        require((n, grid) == (dg_n, dg_grid_shape),
                "RANKS_RUNS and DG_RANKS_RUNS differ in their launches")
        refs = []
        for path, size, _ in dg_runs:
            ref_file = SCRATCH / f"{path}{size}_cg.npy"
            t0 = time.perf_counter()
            ref = time_ranks.one_device_dg(size, path, dev, ref_file)
            torch.cuda.empty_cache()
            print(f"{path} size {size}, one device: {ref['dg_dofs']} DG dofs,"
                  f" frac its {ref['frac_its']:.6f}, rate {ref['rate']:.6e}, "
                  f"L2 {ref['L2']:.9e}, CG {ref['cg_time']:.4f} s; "
                  f"{time.perf_counter() - t0:.1f} s with set-up [{card}]")
            refs.append((ref, ref_file))
        calls = [(cube_program, (poisson_cube_mesh(size, dim),),
                  dict(reps=2, reference=str(rows[dim, size]["cg_file"]),
                       apply_seed=3 if dim == 3 else None,
                       comm_reps=10 if dim == 3 else 0, shape=grid))
                 for dim, size in runs]
        calls += [(dg_program, (poisson_cube_mesh(size),),
                   time_ranks.dg_kwargs(path, ref_file, shape=grid))
                  for (path, size, _), (_, ref_file) in zip(dg_runs, refs)]
        calls += [(dg_program, (poisson_cube_mesh(size, 2),),
                   dict(time_ranks.dg_kwargs(
                       path, dg2_refs[path]["file"], DG2_RANKS_COMM,
                       shape=grid), degree=degree, kind=kind))
                  for path, size, degree, kind in DG2_RANKS_RUNS]
        halo = len(grid) == 2
        if halo:
            calls.append((dg_halo_program, ([(halo_grid, 5, wire, grid)
                                             for wire in ("traces",
                                                          "hermite")],),
                          dict(collect=False, whole=True, comm_reps=5)))
        t0 = time.perf_counter()
        outs = launch(programs, n, "gloo", "cuda", args=(calls,))
        print(f"{n} ranks ({'x'.join(map(str, grid))}, gloo, one card): "
              f"launch {time.perf_counter() - t0:.1f} s")
        for (dim, size), out in zip(runs, outs):
            ranks_row(out, rows[dim, size], n, grid, dim, size, card)
            add(cube_total, out["launches"])
        dg_outs = outs[len(runs):len(runs) + len(dg_runs)]
        for (path, size, _), (ref, ref_file), out in zip(dg_runs, refs,
                                                         dg_outs):
            dg_ranks_row(out, ref, path, n, grid, size, dg_err, card)
            add(dg_total, out["launches"])
            ref_file.unlink()
        dg2_outs = outs[len(runs) + len(dg_runs):][:len(DG2_RANKS_RUNS)]
        for (path, size, _, _), out in zip(DG2_RANKS_RUNS, dg2_outs):
            dg_ranks_row(out, dg2_refs[path], path, n, grid, size, dg_err,
                         card, dim=2)
            add(dg2_total, out["launches"])
        if halo:
            halo_row(outs[-1], halo_grid, grid, card)
    # one rank on nccl: the single-device solvers, bit for bit
    t0 = time.perf_counter()
    cube, dgs = launch(programs, 1, "nccl", "cuda", args=([
        (cube_program, (poisson_cube_mesh(SIZE),), dict(single=True)),
        (dg_programs, (poisson_cube_mesh(DG_RANKS_SINGLE),
                       [dict(path=path, degree=4, kind=kind, n_pre=3,
                             single=True) for path, kind in NCCL_DG]), {})],))
    add(cube_total, cube["launches"])
    print(f"1 rank (nccl), size {SIZE}: FMG bit for bit "
          f"{cube['single']['fmg_equal']}, CG bit for bit "
          f"{cube['single']['cg_equal']} ({cube['single']['its']} its)")
    require(cube["single"]["fmg_equal"] and cube["single"]["cg_equal"],
            "one rank on nccl differs from the single-device solver")
    for (path, _), out in zip(NCCL_DG, dgs):
        add(dg_total, out["launches"])
        print(f"1 rank (nccl), {path} size {DG_RANKS_SINGLE}: CG bit for bit "
              f"{out['single']['cg_equal']}, L2 bit for bit "
              f"{out['single']['L2_equal']} (frac its "
              f"{out['single']['frac_its']:.6f})")
        require(out["single"]["cg_equal"] and out["single"]["L2_equal"],
                f"one nccl rank of {path} differs from the single-device "
                "solver")
    print(f"  nccl launch {time.perf_counter() - t0:.1f} s")
    for ref in dg2_refs.values():
        ref["file"].unlink()
    return cube_total, dg_total, dg2_total


if __name__ == "__main__":
    sys.exit(main())
