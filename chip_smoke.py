#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (iifea_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py`` (``--phases`` runs
a comma-separated subset, for debugging; ``--backend nccl`` runs the
sharded phase on four cards). Phases, each printed on its own line, then
``phase_seconds`` (each phase's wall seconds); the first failure exits
non-zero:

  0. device: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
     requires torch.cuda.is_available().
  1. build: compiles every iifea_tpu_torch/csrc/*.cu (stencil2d.cu,
     stencil2d_f64.cu, stencil3d.cu, stencil3d_f64.cu: each scalar type's
     instances at r = 1-3 of the kernels in stencil2d.cuh and
     stencil3d.cuh; stencil{2d,3d}_r4{,_f64}.cu: the r = 4 ones;
     stencil2d_rn.cu: the runtime-radius ones of stencil_rn.cuh, every
     radius from 5; stencil3d_rn.cu: those of stencil3d.cuh's
     runtime-radius marching kernel, every radius from 5 and the unstaged
     route at r = 1-4) with nvcc (sm_90a), one nvcc per source in
     parallel.
  2. kernels: stencil_mv, jacobi_smooth, stencil_mv_block (the block
     apply and residual in one launch) and smooth (a level's ν sweeps and
     trailing residual, by each route: one launch per pass, and one
     cooperative launch where the level's tiles are co-resident; where
     they are not, that launch must be refused) against their plain
     PyTorch versions on the card,
     for 1 to 3 fields, r = 1, 2, ν = 1, 2, 3, from x and from zero, with
     and without the residual, at odd shapes and at every level shape; at
     every level shape the V-cycles smooth (scalar 1025² … 65², block
     513² … 17² with 2 and with 3 fields; r=2) the device time per launch
     or per smoothing call (a
     CUDA graph of 50 calls, one event pair around its replay), the
     per-call time from an idle card (one event pair around one call: the
     wrapper's host work included) and the bound; the plain versions'
     device times at the main-path shapes. Every stencil2d.cuh instance
     must be built without spill (the compiler's report).
  3. kernels3: stencil_mv3, jacobi_smooth3 and cheb_step3 against their
     plain versions at small shapes and at 105³; a soak of thousands of
     interleaved radius-2 launches over 105³, 53³, 27³ and 14³ (the 3D
     V-cycle's levels), synchronised and compared; times as in phase 2 at
     105³, 53³ and 27³. Then stencil3d_block (the 3D block apply,
     residual, point-block sweep and sweep from zero, one launch each,
     each counted under its pass's name: stencil3d_block, residual3_block,
     sweep3_block, zero3_block; on scalar planes apply3, residual3,
     jacobi_smooth3, zero3) against its plain versions for 1 to 3 fields,
     r = 1, 2, at small shapes and at every level shape of the 3D block
     V-cycle (97³ … 13³), scalar planes also against stencil_mv3 /
     jacobi_smooth3, a soak of interleaved launches and smoothing calls,
     and times of each pass at 3 and 2 fields.
     Then the radius-3
     instances of the three scalar kernels (the 3D biharmonic's, f32 and
     f64; the Chebyshev step with β = 0 and β ≠ 0) against their plain
     versions (f64 to 1e-12) at odd shapes and at 65³, 33³ and 17³, one
     launch a call, a 402-launch soak at 65³, every 3D instance's
     registers and spill from the compiler (no spill allowed), and their
     times at those three shapes. Then smooth3, a 3D level's smoothing call
     (ν sweeps or Chebyshev steps and the residual), at every level shape
     of the 3D elasticity (3 × 97³ … 3 × 13³), Poisson (105³ … 27³) and
     biharmonic (65³ … 17³, f64 and f32) cycles, in both of the V-cycle's
     forms, by each route (one launch a pass; one cooperative launch where
     the plan says the level fits, which must then launch and equal the
     passes bitwise, and be refused where it does not), against its plain
     version, and its times by each route (``smooth3_call`` the routed,
     ``smooth3_other_route`` the other); the scalar cycles' sweep from zero
     (zero3) and residual pass (residual3) checked and timed.
  4. small reference: the card's n_bg=64 2D solution checked with a host
     f64 residual, and the n_bg=24 card and host solutions compared; the
     Chebyshev smoother option inside the n_bg=64 solve.
  5. small reference 3D: the card's n_bg=16 solution checked with a host
     f64 residual; the n_bg=8 card and host solutions' error norms
     compared, and the card's iteration count there (one 9³ level: the
     dense coarse inverse is the whole preconditioner) held to 2x the
     host's 32; the Jacobi smoother option inside the n_bg=16 solve.
  6. main path 2D: BinnedLatticeSolver.solve at n_bg=1024 (1,050,625
     background dofs) once with the kernel launch counters reset (and
     counted per lattice shape), then per-stage times, a profiled warm
     solve (device busy share, top kernels), warm end-to-end times and
     error norms. Then the solver front-end on the same problem (the
     solver freed first): assemble_background_system and
     solve_ksp(pc='mg') with CG and with GMRES, each counted, checked for
     residual, iterations, kernels, device and agreement with the
     BinnedLatticeSolver's solution; then solve_ksp(pc='mg') with BFR
     trimming, whose planes come from the coloured general probe of
     A.mv_multi, with its residual, peak memory and error-norm gates.
  7. main path 3D: the same at n_bg=104 (105³ = 1,157,625 background dofs,
     13,182,000 foreground tetrahedra), with host setup per stage, table
     bytes and peak device memory; the same lattice's refinement with the
     Jacobi smoother option (``StencilMultigrid3D(smoother='jacobi')``, the
     scalar sweep pass's path), counted, to a 1e-8 residual; the front-end
     with CG and the trimmed general-probe solve; its error norms must be
     below those of an n_bg=52 solve.
  8. demo: ``python3 -m iifea_tpu_torch.demos.poisson --ref 4 --solv gmres
     --pc jacobi`` on the card (the general operator, no stencil kernel),
     held against the same demo on the host. The demo phases (8, 10, 15,
     16, 20) call the demo's ``main(argv)`` in this process, what the
     command runs (a process of its own took ~20 s more each).
  9. elasticity (the block path): at n_bg=64 the card's block-MG CG and
     point-block-Jacobi CG against host SuperLU (error norms to 1e-8
     relative); then ``assemble_background_system`` + ``solve_ksp(cg,
     pc='mg', n_fields=2)`` at n_bg=512 (2 × 513² = 526,338 background
     dofs), once counted per lattice shape (every block apply is one
     launch, at most 1,056 stencil launches per solve; no plain stencil
     apply on the card outside the coarsest level's dense inverse), then
     per-stage times, a profiled
     solve and peak memory; its error norms must be below an n_bg=256
     solve's with an L2 rate above 1.5.
  10. demo_elasticity: ``python3 -m iifea_tpu_torch.demos.linear_elasticity
     --mesh-root synthetic --k 1 --ref 3`` on the card (block-MG CG),
     held against the same demo on the host (norms to 1e-8 relative).
  11. elasticity3 (the 3D block path): 3D immersed elasticity at n_bg=8
     and 16 against host SuperLU, then ``solve_ksp(cg, pc='mg',
     n_fields=3)`` at n_bg=96 (3 × 97³ = 2,738,019 background dofs),
     counted per lattice shape (per smoothed level per V-cycle two smooth3
     launches where the plan holds the level in one launch, else 5
     launches: zero3_block, 3 sweep3_block, residual3_block; one
     stencil3d_block apply per Krylov matvec), staged, profiled;
     error norms below an n_bg=48 solve's with an L2 rate above 1.5.
  12. newton: ``solve_nonlinear(linear_pc='mg')`` on the nonlinear
     diffusion form at n_bg=1024 (every Newton step assembled and solved
     on the card, stencil launches in every step), held at n_bg=64
     against the host's iteration count and the Jacobi run's iterate; the
     line-search case and ``solve_newtons_linear`` with pinned dofs.
  13. asm: ``solve_ksp(gmres, pc='asm')`` on immersed Poisson n_bg=256
     against pc='jacobi'.
  14. small_reference_biharmonic: the biharmonic (P2 foreground, quadratic
     B-spline net, radius-3 stencils) at n_bg = 15 and 63 against host
     SuperLU on the same system (L2_rel to 2e-2), the card's iteration count
     at 63 against the port's host f64 run (±2), and at 127 bench.py's
     ``vs_lu_rel_diff`` against its bound.
  15. demo_biharmonic: ``python3 -m iifea_tpu_torch.demos.biharmonic --ref
     2`` on the card against the same demo on the host.
  16. demo_p2: the Poisson demo with ``--k 2`` (P2 spaces) on the card
     against the host.
  17. biharmonic: bench.py --workload biharmonic at n_bg = 511 (513² =
     263,169 background dofs): host set-up and assembly per stage,
     ``solve_ksp(gmres, pc='mg', stencil_radius=3)`` counted per kernel
     and shape (the radius-3 f64 instances by default), three warm solves
     staged, a profiled one, peak memory, error norms below n_bg = 127's;
     then the other route (f32 mixed), counted and capped.
  18. small_reference_biharmonic3: the 3D biharmonic (P2 tetrahedra,
     quadratic B-spline box, radius-3 3D stencils) at n_bg = 7 and 15
     against host SuperLU (L2_rel to 2e-2), at 7 against the port's host
     f64 run (iterations ±2), and at 7, 15 and 31 against the JAX
     package's recorded norms (1e-5 relative).
  19. biharmonic3: ``demos/biharmonic.py --dim 3 --ref 3``'s problem, n_bg
     = 63 (65³ = 274,625 background dofs): host set-up per stage with the
     peak resident set, the assembly, ``solve_ksp(gmres, pc='mg',
     stencil_radius=3)`` counted per kernel, instance and shape (no plain
     apply on the card outside the dense coarse inverse), a warm solve
     staged, a profiled one, peak memory, the f64 residual and the
     L2/H1/H2 norms against the JAX package's ref-3 row (1e-5 relative);
     then the f32-mixed route, counted and capped.
  20. demo_biharmonic3: ``python3 -m iifea_tpu_torch.demos.biharmonic --dim
     3 --ref 0`` on the card against the same demo on the host.
  21. navier_stokes: the Taylor-Green vortex through ``iifea_tpu_torch.
     demos.tg_vortex`` (three-field block MG-GMRES in every Newton
     iteration): ref 2 over T = 1 on the card and on the host (the same
     Newton iterations per step, norms to 1e-6 of the host's and 1e-2 of
     the JAX package's row), then ref 7 (3 × 513² = 789,507 background
     dofs), 3 steps with the pressure pinned, counted per kernel and
     shape, staged (assembly, probe, hierarchy, Krylov), a further step
     profiled; every step within 10 Newton iterations, every linear
     solve converged, L2u below the JAX ref-3 row's, the three-field
     instances launched at every smoothed level, no plain stencil apply
     on the card outside the dense coarse inverse.
  22. shells: the Kirchhoff-Love shells through ``iifea_tpu_torch.demos.
     background_unfitted.pinned_shell_unfitted`` and ``cut_shell_unfitted``
     (nested autodiff element Hessians on the card, host LU of Mᵀ A_f M):
     the pinned demo at --ref 1 on the card and on the host (the same
     Newton iterations, the centre displacement to 1e-8); both demos at
     their defaults (ref 4, 13,068 background dofs; the cut demo's 10 load
     steps), held to the JAX package's golds to 1e-6, per Newton iteration
     the device assembly and the host's to_scipy and LU seconds, the
     pinned run profiled.
  23. poisson_unfitted: ``iifea_tpu_torch.demos.background_unfitted.
     poisson_unfitted --n 16, 32, 64`` on the card, L2 and H1 within 1e-8
     of the JAX package's rows.
  24. determinism: the Taylor-Green ref-7 cell's first linear solve set up
     from nothing three times: the initial state, rhs, planes and solution
     bitwise equal and the same GMRES count; two elasticity n_bg=512
     probes bitwise equal (ROADMAP §3 P5).
  25. sharded: ``bench.py --devices 4`` on the card: the single-device
     hierarchy of the 2D main path (n_bg=1024) built once and handed to
     four ranks (``parallel.sharding.launch``, gloo: four ranks on one card,
     every halo staged through pinned host buffers), each running the
     sharded f32 MG-PCG inside the f64 refinement
     (``parallel.multigrid.refine_sharded``), counted per rank: the kernels
     it launched (``stencil_mv``, ``jacobi_smooth``, ``stencil_mv_block``
     must all launch; no plain apply on the card outside the dense coarse
     inverse), its collectives, seconds and peak memory; f64 residual
     < 1e-10, CG iterations within 4 of the single device's, the solution
     within 1e-7·max|x| on dofs with a diagonal above 0.05 of the largest,
     every rank's solution bitwise equal. On the same ranks the sharded 2D,
     3D (n_bg=52) and block (elasticity n_bg=512) applies and V-cycles
     against their single-device counterparts (a V-cycle with 129² and 65²
     replicated among them) and the cell-sharded ``ShardedProjectedSystem``
     at n_bg=1024 against the operator (1e-10); then ``demos/poisson.py
     --devices 4 --ref 4`` against the single-device demo with CG (norms
     to 1e-8). ``--backend nccl`` runs the phase with one rank on each of
     four cards.
  26. mesh_files: the mesh-file door (``mesh/io``'s CSV readers,
     ``ExtractionOperator.from_exop_csv``, the Kirsch plate's
     ``ElasticityProblem`` through ``demos/linear_elasticity.kirsch``; the
     general operator, host SuperLU, GMRES with asm or Jacobi: no stencil
     kernel). The card machine has no h5py: the meshes are built in memory
     and their ExOp_Cons.csv and cell_nodes.csv written and read back. The
     fitted quarter plate at 72,771 vertices on a trimmed quadratic
     B-spline net (k = 1, SuperLU, profiled, per stage), at a quarter of
     the size on the card and on the host, in P2 at 72,771 nodes on
     shuffled Exodus ids (SuperLU, GMRES with asm and with Jacobi), and a
     P2 Poisson square (its triples trimmed to the block) on shuffled
     Exodus ids against its own numbering; gates on residuals, the stress
     error's rate, P2 below P1, asm within Jacobi's iterations, card
     against host, the CSV's M bitwise, the shuffled system and one
     solution's norms through each numbering.

  27. f64_routes (run after mesh_files, before the biharmonics): every
     solve_ksp(pc='mg') configuration on the card. The f64 and radius-3
     instances (f64 blocks at r = 1–3, f32 blocks at r = 3, 2 and 3 fields, 2D
     and 3D; f64 3D scalar planes at r = 1, 2) against their plain versions
     at odd shapes and at their paths' level shapes, by both smoothing
     routes, a soak, and their times; the f64 route (``mixed=False``) of
     the systems the elasticity, elasticity3, main_path3 (front-end) and
     determinism (Taylor-Green ref 7) phases built, solved inside those
     phases (``f64_route``: counted, residual, iterations against the mixed
     route's, the foreground field against the mixed solution's); the
     Taylor-Green ref-2 first system and the B-spline elasticity (k = 2,
     radius 3, two fields) at n_bg = 15 card against host, at n_bg = 511 on
     both routes with its L2 rate from n_bg = 127; the 3D counterpart card
     against host on the 9³ net and on the card at n_bg = 15.
  28. cubic (run after the biharmonics): radius 4, the
     cubic B-spline background. The biharmonic on the 513² cubic net
     (n_bg = 510, ``solve_ksp(gmres, pc='mg', stencil_radius=4)``, f64)
     counted, staged, profiled, below 1e-10 in at most 100 iterations, its
     L2_rel below the 257² net's, the outer ring's share of its planes;
     card against host on the 17² net; the cubic elasticity (two fields)
     on the 513² net by both routes; the 3D biharmonic on the 9³ net card
     against host and on the 33³ net by both routes (the f32 mixed one
     capped at the other routes' cap), the three-field 3D
     elasticity on the 9³ net against host SuperLU and on the 17³ net,
     each 3D solve capped (the 3D cycles are weak at radius 4).
  29. quartic (after cubic): radius 5, the quartic B-spline background,
     on the runtime-radius instances. The biharmonic on the 513² quartic
     net (n_bg = 509, ``solve_ksp(gmres, pc='mg', stencil_radius=5)``, f64)
     counted, staged, profiled, below 1e-10 in at most 1,800 iterations
     (the quartic cycle is weak, the JAX package's as the port's), its
     L2_rel below the 257² net's, the outer ring's (offset 5) share of its
     planes; card against host on the 17² net (to 1e-12); the 3D biharmonic
     on the 9³ net card against host (both capped) and on the 33³ net by
     both routes, capped, each residual reached below 2e-7.
  30. elasticity3_wide (last): the three-field cubic 3D elasticity on the
     73³ net (n_fg = n_bg = 70; 3 × 73³ dofs), whose finest level's
     marching passes stage one field's x planes at a time (the plan's
     per-field staging), counted, peak memory, 30 capped GMRES iterations
     whose residual must never rise.

Phases 22, 23, 25 and 26 (shells, poisson_unfitted, sharded, mesh_files,
``CHILD_PHASES``) run in a child process (``--child``), started once
phases 2 and 3 have taken the kernels' times, beside phases 4 to 21; their
lines are printed, and the child's failure fails the script, before phase
24; ``child_phase_seconds`` gives their seconds, ``phase_seconds``' key
``child_wait`` the time this process waited for the child.

Phase 2 also holds the radius-3 (f32, f64) and f64 (r = 1, 2) instances of
the 2D entries against their plain versions (f64 to 1e-12) at odd shapes
and at every level of the 513² hierarchy, and times the radius-3 ones there;
then the radius-4 instances (f32, f64; scalar, 2 and 3 fields) at odd shapes
and at the cubic paths' levels, timed where those paths run them; then the
runtime-radius instances at r = 5 likewise (the quartic net's levels; no
spill). Phase 3 does the same for the 3D radius-4 instances (33³, 17³;
three fields at 17³, 9³) and the r = 5 ones (33³, 17³); holds the 3D
marching passes by every staging the lattice takes and the runtime-radius
kernel's unstaged route (x read through the read-only cache, the only
route at r = 5, 6, 7) against their plain versions, 1–3 fields, at odd
shapes, the quartic levels and a long-k lattice only the unstaged route
takes (also at r = 4), each route again with NaN in the taps outside the
lattice (every output bitwise as it was: no kernel reads them), and times
the r = 5 three-field f64 passes at 3 × 17³; and holds the per-field staging (f64, r = 4, three fields) bitwise equal to the
all-field staging at 65³ and three odd shapes, every pass and a level's
smoothing call by one launch a pass (a level's one launch refuses it),
timed with its library call at 3 × 65³, and each pass against its plain
version at 3 × 97³, timed at 3 × 73³.
Each apply and residual row timed with its plain version (and the per-field
ones at 3 × 65³) also times one
PyTorch call that computes the same function, ``library_ms``: ``torch.mv``
(``torch.addmv`` for b − A x) on the planes' operator as a CSR tensor with
int32 indices (cuSPARSE SpMV), built untimed; nothing in the port calls it.

Then ``kernel_shapes``: every timed (kernel, shape) with its launches in the
main-path solves (2D, 3D and elasticity, added) and launches × (device ms
− bound ms) per kernel; a block operator's shape carries its field count
first (2x513x513), and a smoothing call is booked by its form
(``smooth_call@…:pre`` from zero with the residual, ``:post`` from x).
The line before the last is the kernel summary JSON (the radius-3
instances, 2D and 3D, as rows of their kernel's name with an ``instance``
key, their launches from the biharmonics' two routes; the three-field 2D
instances as rows with ``instance`` "nf3", their launches from the
Taylor-Green cell), the last line the
device JSON. Each row's launches are those counted under its name, and its
times are those of the one ``kernel_time`` row of that name and instance
timed with its plain version, at a main-path shape where that kernel runs
(``smooth3``: a level the plan gives one launch). The f64_routes phase adds
rows tagged by instance and field count (``/f64/nf2``, ``/r3/nf2``, …),
their launches from the f64 route runs; the cubic phase adds the radius-4
rows (``/r4``, ``/r4/f64``, ``/r4/f64/nf2``, …), their launches from its runs;
the quartic phase the radius-5 rows (``/r5/f64``, ``/r5``; source
stencil_rn.cuh in 2D, stencil3d.cuh in 3D); elasticity3_wide the per-field
staging's rows (``/r4/f64/nf3/pf``: the launches at its 73³ level).
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SOURCE2, SOURCE3 = ("iifea_tpu_torch/csrc/stencil2d.cuh",
                    "iifea_tpu_torch/csrc/stencil3d.cuh")
# the runtime-radius instances of the 2D kernels (r >= 5; the 3D ones are
# stencil3d.cuh's march_rn_kernel)
SOURCE_RN = "iifea_tpu_torch/csrc/stencil_rn.cuh"
KERNELS = {   # name: (source, TPU kernel it replaces)
    "stencil_mv": (SOURCE2, "iifea_tpu/ops/pallas_stencil.py:127"),
    "jacobi_smooth": (SOURCE2, "iifea_tpu/ops/pallas_stencil.py:136"),
    "stencil_mv3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:325"),
    "jacobi_smooth3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:332"),
    # the fused Chebyshev step extends jacobi_smooth3 to the 3D V-cycle's
    # smoother: one pass per sweep
    "cheb_step3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:332"),
    # stencil_mv for block operators: all nF output fields in one launch,
    # with the residual epilogue b − A x
    "stencil_mv_block": (SOURCE2, "iifea_tpu/ops/pallas_stencil.py:127"),
    # jacobi_smooth for a whole level: ν sweeps and the residual in one
    # launch (a cooperative grid)
    "smooth": (SOURCE2, "iifea_tpu/ops/pallas_stencil.py:136"),
    # the 3D marching kernel's other passes on scalar planes: the V-cycle's
    # residual b − A x (the reference's b − stencil_mv3), and its
    # pre-smoother's first step, the sweep from zero ω·invd·b (a
    # jacobi_smooth3 from x = 0; march_zero_kernel, which reads no plane)
    "residual3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:325"),
    "zero3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:332"),
    # stencil_mv3 / jacobi_smooth3 for 3D block operators, all nF fields in
    # one launch: the apply, the residual, the point-block sweep and the
    # sweep from zero
    "stencil3d_block": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:325"),
    "residual3_block": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:325"),
    "sweep3_block": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:332"),
    "zero3_block": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:332"),
    # jacobi_smooth3 for a whole 3D level: ν sweeps or Chebyshev steps and
    # the residual in one launch (a cooperative grid)
    "smooth3": (SOURCE3, "iifea_tpu/ops/pallas_stencil.py:332"),
}
# The rows of the summary's kernels line, by instance (a row's
# "instance"; "": the f32 radius-1-2 instances): each must be there with
# launches from a full-width path, so that a row cannot drop out of the
# line unseen when a phase stops running the route that launches it
_P2 = ("jacobi_smooth", "stencil_mv_block", "smooth")
_P3 = ("stencil_mv3", "cheb_step3", "residual3", "zero3")
_B3 = ("stencil3d_block", "residual3_block", "sweep3_block", "zero3_block")
SUMMARY_ROWS = {
    "": tuple(KERNELS),
    "f64": _P3 + ("smooth3",), "f64 nf2": _P2, "f64 nf3": _P2 + _B3
    + ("smooth3",), "nf3": _P2,
    "r3": ("stencil_mv",) + _P2 + _P3 + ("smooth3",),
    "r3 f64": ("stencil_mv",) + _P2 + _P3 + ("smooth3",),
    "r3 f64 nf2": _P2, "r3 nf2": _P2,
    "r4": _P3 + ("smooth3",),
    "r4 f64": ("stencil_mv",) + _P2 + ("stencil_mv3", "smooth3"),
    "r4 f64 nf2": _P2, "r4 nf2": _P2,
    # (the three-field f64 r = 4 levels, 3 × 17³ and 3 × 19³, hold 169 and
    # 248 MB of coefficients, past the L2: one launch a pass, level_pays)
    "r4 f64 nf3": _B3, "r4 f64 nf3 pf": _B3,
    "r5": _P3 + ("smooth3",), "r5 f64": ("stencil_mv",) + _P2 + _P3
    + ("smooth3",),
}
TOL = 1e-4          # max|y - y_plain| <= TOL * max|y_plain| (f32 sum order)
TOL64 = 1e-12       # the same for the f64 instances (fma against mul + add)
GRAPH_LAUNCHES = 50           # captured calls per timed CUDA graph
# the V-cycle's smoothed levels (the coarsest, 33² and 14³, is dense)
LEVELS2 = [(s_, s_) for s_ in (1025, 513, 257, 129, 65)]
# the block V-cycle smooths 513² down to 17² (9² is dense); the shapes it
# adds to LEVELS2 (stencil_mv only: it smooths by point-block Jacobi)
BLOCK_SMOOTHED = [(s_, s_) for s_ in (513, 257, 129, 65, 33, 17)]
BLOCK_EXTRA = [s_ for s_ in BLOCK_SMOOTHED if s_ not in LEVELS2]
N_FIELDS_EL = 2               # fields of the elasticity block operator
N_FIELDS_NS = 3               # fields of the Navier-Stokes block operator
# the biharmonic (bench.py --workload biharmonic): a 513² quadratic B-spline
# net, radius-3 stencils; the V-cycle smooths 513² … 65², 33² is dense
N_BG_BH = 511
LEVELS_BH = [(s_, s_) for s_ in (513, 257, 129, 65)]
DENSE_BH = (33, 33)
ODD_SHAPES = [(17, 17), (33, 129), (40, 200)]
# the V-cycle's two smoothing calls per level: (from zero, with residual)
FORMS = {"pre": (True, True), "post": (False, False)}
NU = 2                        # sweeps per smoothing call (nu_pre = nu_post)
MAX_STENCIL_LAUNCHES_EL = 1056   # a quarter of the 4,224 of nF² launches
MAX_LAUNCHES_EL = 8500        # all kernels of the profiled elasticity solve
LEVELS3 = [(s_,) * 3 for s_ in (105, 53, 27)]
N_BG_EL3 = 96                 # 97 → 49 → 25 → 13 smoothed, 3 × 7³ dense
N_FIELDS_EL3 = 3
BLOCK3_SMOOTHED = [(s_,) * 3 for s_ in (97, 49, 25, 13)]
# the 3D block cycle (ω = 1 point-block Jacobi on l1-regularised blocks, as
# the reference's) is not mesh-independent: on the host the port takes 88 /
# 108 / 128 CG iterations at n_bg = 16 / 24 / 32
# (tests/compare_block_mg_iters.py --dim 3); the bound leaves that growth
# room up to n_bg = 96 and catches a cycle that stops contracting
MAX_CG_ITERS_EL3 = 400
MAX_CG_ITERS_EL3_SINGLE = 60     # the reference's bound at one dense level
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12             # H100 SXM f32 rate outside the tensor cores
F64_FLOPS = 34e12             # H100 SXM f64 rate outside the tensor cores
# f32 vectors each kernel reads or writes once besides its coefficient
# planes: x, y; + invd, b; + d read and written
VECTORS = {"stencil_mv": 2, "jacobi_smooth": 4, "stencil_mv3": 2,
           "jacobi_smooth3": 4, "cheb_step3": 6}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(tag: str, **kv) -> None:
    print(json.dumps({"phase": tag, **kv}), flush=True)


def call_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of one call of fn() from an idle card: one CUDA
    event pair around the call, so the interval holds the wrapper's host
    work before the launch as well as the kernel."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, launches: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """Device milliseconds per call of fn(): a CUDA graph of ``launches``
    captured calls (cooperative launches are captured like any other), one CUDA event pair around each replay, divided by the count;
    the median of ``reps`` replays. No host time is in the interval.
    Consecutive calls find their operands in the 50 MB L2 where they fit,
    as the V-cycle's repeated sweeps on one level do."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    times.sort()
    return times[len(times) // 2]


def instance_tag(radius: int = 2, f64: bool = False, n_fields: int = 1,
                 dim: int = 2) -> str:
    """The tag of a kernel instance in launch keys, worst errors, timed
    rows and summary rows: empty for the f32 instances at radius 1 and 2
    (the earlier main paths'), "/r3", "/r4", "/f64", "/r3/f64", "/r4/f64"
    otherwise, and "/nf3" after it for the three-field 2D f32 instances at
    radius 1 and 2 (the Taylor-Green path's); the block instances in f64
    or at radius 3 and 4, 2D and 3D, carry their field count ("/f64/nf2",
    "/r3/f64/nf3", …)."""
    tagged = radius >= 3 or f64
    return ((f"/r{radius}" if radius >= 3 else "") + ("/f64" if f64 else "")
            + (f"/nf{n_fields}" if n_fields > 1 and tagged
               else "/nf3" if dim == 2 and n_fields == 3 else ""))


def time_kernel(name, shape, fn, plain=None, bound_=None, plain_launches=10,
                radius: int = 2, f64: bool = False, n_fields: int = 1,
                dim: int = 2, library=None, graph_launches=GRAPH_LAUNCHES,
                **kv) -> dict:
    """One ``kernel_time`` line: device ms (a graph of ``graph_launches``
    calls), call ms and bound at ``shape`` (and the plain version's device
    ms where ``plain`` is given, the library call's where ``library`` is:
    ``library_ms``), with the ``instance`` tag. ``bound_`` is (ms, by)
    where the row is not one launch of ``name``."""
    b_ms, by = bound_ or bound(name, shape, radius, f64)
    row = {"kernel": name, "shape": list(shape), "radius": radius,
           "dtype": "f64" if f64 else "f32",
           "instance": instance_tag(radius, f64, n_fields, dim), **kv,
           "device_ms": device_ms(fn, launches=graph_launches),
           "call_ms": call_ms(fn, reps=5 if graph_launches < 10 else 20),
           "bound_ms": b_ms, "bound_by": by}
    if plain is not None:
        row["plain_ms"] = device_ms(plain, launches=plain_launches, reps=3)
    if library is not None:
        row["library_ms"] = library_ms(library())
    row["share_of_bound"] = b_ms / row["device_ms"]
    row["l2_resident"] = l2_resident(b_ms, by)
    phase("kernel_time", **row)
    return row


def l2_resident(b_ms: float, by: str) -> bool:
    """Whether the compulsory bytes of a row bound by bytes fit the card's
    L2 cache: a graph that replays one call on the same operands then reads
    them from the L2, which the memory rate does not bound."""
    import torch

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 * 2 ** 20)
    return by == "bytes" and b_ms * 1e-3 * HBM_BYTES_PER_S <= l2


# the most a row's share of its bound may read: a kernel cannot beat the
# least time the card needs for the same work (rows whose operands the L2
# holds excepted, ``l2_resident``), so a share above this is a wrong bound
# or a wrong time
MAX_SHARE_OF_BOUND = 1.05


def check_shares(timing) -> None:
    """Fails the run where a row not ``l2_resident`` reads above
    MAX_SHARE_OF_BOUND of its bound; prints the highest shares."""
    over = [r for r in timing if r["share_of_bound"] > MAX_SHARE_OF_BOUND]
    held = [r for r in over if not r["l2_resident"]]

    def brief(r):
        return [r["kernel"], r["shape"], r["instance"], r["share_of_bound"]]

    top = max((r for r in timing if not r["l2_resident"]),
              key=lambda r: r["share_of_bound"], default=None)
    phase("bound_check", rows=len(timing), limit=MAX_SHARE_OF_BOUND,
          highest=None if top is None else brief(top),
          over_limit=[brief(r) for r in held],
          l2_resident_over_limit=[brief(r) for r in over
                                  if r["l2_resident"]])
    if held:
        fail(f"rows above {MAX_SHARE_OF_BOUND} of their bound: "
             f"{[brief(r) for r in held]}")


def planes_csr(C, shape, radius: int, chunks: int = 64):
    """The operator of stencil planes ``C`` (scalar (m^d, *shape) or block
    (nF, nF, m^d, *shape)) as a CSR tensor on C's device, with int32
    indices where its nonzeros allow (int64 past 2³¹): row (f1, node)
    holds, for each f2 and each tap whose x lies in the lattice, the column
    f2·n + node + offset, in the planes' order (ascending columns). Taps
    outside the lattice, which multiply the zero padding, are left out;
    every other coefficient is kept. Built in ``chunks`` runs of nodes,
    each written in place (a 1.6 G-nonzero operator in one masked select
    held 48 GiB of indices)."""
    import itertools

    import torch

    dim, dev = len(shape), C.device
    nF = C.shape[0] if C.dim() == dim + 3 else 1
    m = 2 * radius + 1
    n = math.prod(shape)
    taps = torch.tensor(list(itertools.product(range(-radius, radius + 1),
                                               repeat=dim)), device=dev)
    node = torch.arange(n, device=dev)
    valid = torch.ones((n, m ** dim), dtype=torch.bool, device=dev)
    delta = torch.zeros(m ** dim, dtype=torch.int64, device=dev)
    stride = n
    for a, side in enumerate(shape):
        stride //= side
        at = (node // stride % side)[:, None] + taps[None, :, a]
        valid &= (at >= 0) & (at < side)
        delta += taps[:, a] * stride
    start = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    start[1:] = valid.sum(dim=1).cumsum(0)
    nv = int(start[-1])
    index = torch.int32 if nF * nF * nv < 2 ** 31 else torch.int64
    vals = torch.empty(nF * nF * nv, dtype=C.dtype, device=dev)
    cols = torch.empty(nF * nF * nv, dtype=index, device=dev)
    planes = C.reshape(nF, nF, m ** dim, n)
    field = n * torch.arange(nF, device=dev)
    step = -(-n // chunks)
    for a in range(0, n, step):
        b = min(n, a + step)
        k0, k1 = int(start[a]), int(start[b])
        mask = valid[a:b]
        # (f1, node, f2, tap) and (node, f2, tap) in row-major order
        v = planes[..., a:b].permute(0, 3, 1, 2).masked_select(
            mask[None, :, None, :]).view(nF, nF * (k1 - k0))
        c = (node[a:b, None, None] + delta[None, None, :]
             + field[None, :, None]).masked_select(mask[:, None, :])
        for f1 in range(nF):
            at = f1 * nF * nv + nF * k0
            vals[at:at + nF * (k1 - k0)] = v[f1]
            cols[at:at + nF * (k1 - k0)] = c
        del v, c
    crow = torch.zeros(nF * n + 1, dtype=torch.int64, device=dev)
    crow[1:] = (nF * (start[1:] - start[:-1])).repeat(nF).cumsum(0)
    return torch.sparse_csr_tensor(crow.to(index), cols, vals,
                                   (nF * n, nF * n))


def csr_call(C, shape, radius: int, x, b=None):
    """A function that builds the CSR form of the planes (``planes_csr``,
    untimed) and returns one PyTorch call that computes what the apply (b
    None: ``torch.mv``, cuSPARSE SpMV on a card) or the residual (b − A x:
    ``torch.addmv``) computes on the same operands. Timed beside the
    kernels as their library yardstick; no path of the port calls it."""
    import torch

    def make():
        A = planes_csr(C, shape, radius)
        if b is None:
            return partial(torch.mv, A, x)
        return partial(torch.addmv, b, A, x, beta=1.0, alpha=-1.0)
    return make


def library_ms(fn, launches: int = 20) -> float:
    """Device milliseconds per call of a library call: one CUDA event pair
    around ``launches`` calls enqueued back to back (no graph: a library
    call may allocate its workspace), after three warm calls; the median
    of three such runs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    times.sort()
    return times[1]


def _bound_ms(words: float, flops: float, n: int,
              f64: bool = False) -> tuple[float, str]:
    """The larger of ``words`` values per point (f32, or f64) over the
    memory rate and ``flops`` per point over the rate of their type, on n
    points, in ms."""
    t_bytes = (8.0 if f64 else 4.0) * n * words / HBM_BYTES_PER_S
    t_ops = flops * n / (F64_FLOPS if f64 else F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lattice_taps(shape, radius: int) -> float:
    """The taps a point of the lattice ``shape`` (2D or 3D) needs, on
    average: those whose x lies in the lattice. The others multiply the
    zero padding, and the function needs neither their coefficients nor
    their multiply-adds (the nonzeros ``planes_csr`` keeps are these taps,
    nF² per point and tap). Per axis of n points the offsets in the lattice
    number n(2r+1) − r(r+1) for n > r, summed exactly below that; the
    lattice's are the product of its axes'."""
    total, n = 1, 1
    for side in shape:
        total *= sum(min(side - 1, p + radius) - max(0, p - radius) + 1
                     for p in range(side))
        n *= side
    return total / n


def bound(name: str, shape, radius: int = 2,
          f64: bool = False) -> tuple[float, str]:
    """Least milliseconds the card needs for one call at ``shape``: the
    larger of the compulsory bytes (each coefficient the function needs,
    ``lattice_taps`` a point, and each vector read or written once) over
    the memory rate and the multiply-adds over their type's rate. Returns
    (ms, "bytes" | "operations")."""
    taps = lattice_taps(shape, radius)
    return _bound_ms(taps + VECTORS[name], 2.0 * taps + 4.0,
                     math.prod(shape), f64)


def bound_passes(shape, n_fields: int, passes, radius: int = 2,
                 f64: bool = False):
    """The bound of a sequence of passes on an nF-field 2D or 3D (by
    ``shape``'s rank) operator, the
    same work whatever launches carry it: per pass every value it needs
    moved once. "apply": nF² plane sets, x read, y written; "residual":
    also b read; "sweep": also the nF² Binv planes; "zero" (the sweep from
    x = 0): Binv and b read, x written, no plane. A plane set counts the
    taps in the lattice (``lattice_taps``). nF = 1 gives ``bound``'s
    stencil_mv and jacobi_smooth."""
    nF, taps = n_fields, lattice_taps(shape, radius)
    n = math.prod(shape)
    words = {"apply": nF * nF * taps + 2 * nF,
             "residual": nF * nF * taps + 3 * nF,
             "sweep": nF * nF * (taps + 1) + 3 * nF,
             "zero": nF * nF + 2 * nF}
    flops = {"apply": 2.0 * nF * nF * taps,
             "residual": 2.0 * nF * nF * taps + nF,
             "sweep": 2.0 * nF * nF * (taps + 1) + 3.0 * nF,
             "zero": 3.0 * nF * nF}
    return _bound_ms(sum(words[p] for p in passes),
                     sum(flops[p] for p in passes), n, f64)


def bound_call(shape, n_fields: int, sweeps: int, from_zero: bool,
               with_residual: bool, radius: int = 2, f64: bool = False):
    """The bound of one smoothing call (2D or 3D, by ``shape``'s rank) as a
    function of its operands: every input read once (the nF² plane sets,
    the nF² Binv planes or 1/diag, b, and x unless from zero) and every
    output written once (x_ν, and r with the residual), whatever passes
    carry it (a Chebyshev direction is scratch, not an operand); the
    operations are those of its passes, which no fusion saves. A plane set
    counts the taps in the lattice (``lattice_taps``)."""
    nF, taps = n_fields, lattice_taps(shape, radius)
    n = math.prod(shape)
    words = (nF * nF * (taps + 1) + nF + nF * (not from_zero) + nF
             + nF * with_residual)
    sweep, zero = 2.0 * nF * nF * (taps + 1) + 3.0 * nF, 3.0 * nF * nF
    first = zero if from_zero and sweeps > 0 else 0.0
    flops = (first + sweep * (sweeps - bool(first))
             + (2.0 * nF * nF * taps + nF) * with_residual)
    return _bound_ms(words, flops, n, f64)


def passes_of(sweeps: int, from_zero: bool, with_residual: bool):
    """The passes of one smoothing call."""
    return (["zero"] * (from_zero and sweeps > 0)
            + ["sweep"] * (sweeps - bool(from_zero and sweeps > 0))
            + ["residual"] * with_residual)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from iifea_tpu_torch.ops import stencil_kernels as sk

    nv = subprocess.run([sk._nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60)
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          nvcc=nv.stdout.strip().splitlines()[-1] if nv.stdout else None,
          name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())


def phase_build():
    from iifea_tpu_torch.ops import stencil_kernels as sk

    t = time.perf_counter()
    path = sk.build()
    sk._lib()
    dt = time.perf_counter() - t
    log = path.with_suffix(".log")
    phase("build", seconds=dt, library=str(path.relative_to(HERE)),
          sources=[str(p.relative_to(HERE)) for p in sk.SOURCES],
          ptxas=ptxas_report(log.read_text() if log.exists() else ""))


def ptxas_report(log: str) -> list:
    """Per kernel of the compiler's ``-Xptxas -v`` report: registers, shared
    memory, stack and spill bytes. The name is the mangled one cut to the
    kernel and its template arguments."""
    rows, row = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"\d+((?:pass|level|stencil|march)\w*?)E?v?P",
                             m.group(1))
            row = {"kernel": name.group(1) if name else m.group(1)}
            rows.append(row)
        elif row is not None:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    row[key] = int(m.group(1))
    return rows


def _check(worst, name, y, y_ref, shape, radius, quiet=False, scale=None,
           **kv):
    """Hold y against y_ref at TOL·max|scale| (f64: TOL64; scale: y_ref
    unless given, a smoothed residual is held to the size of its terms, b);
    fails above it. ``quiet`` prints nothing (the caller prints a summary
    line). The worst error is booked under the kernel's name and instance
    tag. Returns the error."""
    import torch

    torch.cuda.synchronize()
    f64 = y.dtype == torch.float64
    err = float((y - y_ref).abs().max())
    lim = (TOL64 if f64 else TOL) * float((y_ref if scale is None
                                           else scale).abs().max())
    if not quiet:
        phase("kernel_check", kernel=name, shape=list(shape), radius=radius,
              max_abs_err=err, bound=lim, **kv)
    if not err <= lim:
        fail(f"{name} {shape} r={radius} {y.dtype} {kv}: {err} > {lim}")
    key = name + instance_tag(radius, f64, kv.get("n_fields", 1),
                              len(shape))
    worst[key] = max(worst.get(key, 0.0), err)
    return err


ROUTES = ("per_pass", "grid")                 # sk.PER_PASS, sk.GRID
# the 3D marching passes' stagings (sk.ALL_FIELDS, sk.PER_FIELD,
# sk.UNSTAGED)
STAGINGS = ("all_fields", "per_field", "unstaged")


def level_operands(rng, shape, radius, n_fields, dev, dtype=None):
    """A diagonally dominant nF-field operator (n_fields = 0: scalar
    planes and the flat 1/diag), its smoother blocks, b and x on the
    card, in ``dtype`` (default f32)."""
    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops.stencil import StencilOperatorBlock2D

    dtype = dtype or torch.float32
    nF, m2 = max(n_fields, 1), (2 * radius + 1) ** 2
    C = torch.tensor(rng.uniform(-0.1, 0.1, (nF, nF, m2, *shape)),
                     dtype=dtype, device=dev)
    for f in range(nF):
        C[f, f, m2 // 2] += 4.0
    n = nF * shape[0] * shape[1]
    b, x = (torch.tensor(rng.standard_normal(n), dtype=dtype,
                         device=dev) for _ in range(2))
    if n_fields == 0:
        C = C[0, 0].contiguous()
        return C, (1.0 / C[m2 // 2]).reshape(-1).contiguous(), b, x
    return C, multigrid._point_binv(StencilOperatorBlock2D(C, shape,
                                                           radius)), b, x


TILE = (8, 32)     # output rows x columns per block of csrc/stencil2d.cuh
RN_TILE = 16       # ... and of csrc/stencil_rn.cuh (r >= 5), a side


def fitting_routes(C, binv, b, x, shape, radius, nF):
    """The routes of a smoothing call that take this level: one launch per
    pass always, the fused launch where the library's plan (tile count
    against the co-resident blocks) says the level fits. The plan is held
    to the launch: a level that fits must launch (a fused launch that
    raises there fails the run), one that does not fit must be refused."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    import torch

    routed = sk._smooth_route(tuple(shape), radius, nF, b.device.index or 0,
                              b.dtype == torch.float64)
    tile = TILE if radius < 5 else (RN_TILE, RN_TILE)
    tiles = -(-shape[0] // tile[0]) * -(-shape[1] // tile[1])
    try:
        sk._smooth_cuda(sk.GRID, C, binv, b, x, 0.8, 1, shape, radius, nF,
                        True)
        launched = True
    except RuntimeError as e:
        launched, why = False, str(e)
    if launched != (routed == sk.GRID):
        fail(f"smooth at {shape} nF={nF}, {tiles} tiles: the plan says "
             f"{ROUTES[routed]}, the fused launch "
             + ("ran" if launched else f"was refused: {why}"))
    return [sk.PER_PASS] + [sk.GRID] * launched


def check_level_entries(worst, rng, shape, radius, n_fields, dev, sweeps,
                        forms, dtype=None):
    """stencil_mv_block (apply, residual: one launch each) and smooth by
    every route against their plain versions at ``shape``; the fused
    route must be one launch a call. Prints one summary line; returns
    whether every fused result equalled the per-pass launches bitwise."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    C, binv, b, x = level_operands(rng, shape, radius, n_fields, dev, dtype)
    nF = max(n_fields, 1)
    y_ref = sk.apply_plain(C, x, shape, radius)
    before = sk.launches()
    y = sk.stencil_mv_block(C, x, shape, radius)
    r = sk.stencil_mv_block(C, x, shape, radius, b=b)
    if sk.launches() != {**before, "stencil_mv_block":
                         before["stencil_mv_block"] + 2}:
        fail(f"block apply and residual at {shape} were not one "
             f"stencil_mv_block launch each: {before} -> {sk.launches()}")
    errs = [_check(worst, "stencil_mv_block", y, y_ref, shape, radius,
                   quiet=True, n_fields=n_fields),
            _check(worst, "stencil_mv_block", r, b - y_ref, shape, radius,
                   quiet=True, n_fields=n_fields, what="residual")]
    bitwise, checks = True, 2
    fits = fitting_routes(C, binv, b, x, shape, radius, nF)
    for nu in sweeps:
        for from_zero, with_residual in forms:
            start = None if from_zero else x
            ref = sk.smooth_plain(C, binv, b, start, 0.8, nu, shape, radius,
                                  with_residual)
            outs, ran = [], []
            for route in fits:
                before = sk.smooth.launches
                outs.append(sk._smooth_cuda(route, C, binv, b, start, 0.8,
                                            nu, shape, radius, nF,
                                            with_residual))
                ran.append(ROUTES[route])
                if sk.smooth.launches - before != (route != sk.PER_PASS):
                    fail(f"smooth {ROUTES[route]} at {shape} made "
                         f"{sk.smooth.launches - before} fused launches")
            outs.append(sk.smooth(C, binv, b, start, 0.8, nu, shape, radius,
                                  with_residual))
            for route, out in zip((*ran, "routed"), outs):
                name = "jacobi_smooth" if route == "per_pass" else "smooth"
                for k, (v, v_ref) in enumerate(
                        zip(*((out, ref) if with_residual
                              else ((out,), (ref,))))):
                    errs.append(_check(
                        worst, name, v, v_ref, shape, radius, quiet=True,
                        n_fields=n_fields, sweeps=nu, from_zero=from_zero,
                        route=route, what="residual" if k else "x"))
                    first = outs[0][k] if with_residual else outs[0]
                    bitwise &= bool(torch.equal(v, first))
                    checks += 1
    phase("kernel_check", kernel="stencil_mv_block, smooth",
          shape=list(shape), radius=radius, n_fields=n_fields,
          sweeps=list(sweeps), forms=[list(f) for f in forms],
          routes=[*(ROUTES[d] for d in fits), "routed"], checks=checks,
          max_abs_err=max(errs), fused_bitwise_equal_per_pass=bitwise,
          dtype=str(C.dtype).replace("torch.", ""),
          routed=ROUTES[sk._smooth_route(tuple(shape), radius, nF,
                                         dev.index or 0,
                                         C.dtype == torch.float64)])
    return bitwise


def time_level(rng, shape, n_fields, dev, main_block, main_smooth,
               radius: int = 2, dtype=None):
    """``kernel_time`` rows of the block entries at one level shape (r=2,
    f32 unless ``radius``/``dtype`` say otherwise):
    stencil_mv_block (apply), and each form of the V-cycle's smoothing call
    (NU sweeps; "pre" from zero with the residual, "post" from x) by every
    route that takes the level, the routed one as kernel "smooth_call".
    ``bound_ms`` is the call's (``bound_call``: operands moved once),
    ``per_pass_bound_ms`` the sum of its passes' bounds, which the rows
    of single launches add up to. ``main_*``: also time the plain version
    (the rows of the kernel summary)."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    import torch

    r = radius
    C, binv, b, x = level_operands(rng, shape, r, n_fields, dev, dtype)
    f64 = C.dtype == torch.float64
    nF = max(n_fields, 1)
    key = list(shape) if n_fields == 0 else [nF, *shape]
    tag = {"n_fields": nF}
    rows = [time_kernel(
        "stencil_mv_block", key, partial(sk.stencil_mv_block, C, x, shape, r),
        partial(sk.apply_plain, C, x, shape, r) if main_block else None,
        bound_=bound_passes(shape, nF, ["apply"], r, f64), radius=r,
        f64=f64, library=csr_call(C, shape, r, x) if main_block else None,
        **tag)]
    if main_block and (nF == 3 or (nF > 1 and (f64 or r >= 3))):
        # the sweep pass, counted as jacobi_smooth
        rows.append(time_kernel(
            "jacobi_smooth", key,
            partial(sk._sweep_cuda, C, binv, b, x, 0.67, shape, r, nF),
            partial(sk.sweep_plain, C, binv, b, x, 0.67, shape, r),
            bound_=bound_passes(shape, nF, ["sweep"], r, f64), radius=r,
            f64=f64, **tag))
    routed = sk._smooth_route(tuple(shape), r, nF, dev.index or 0, f64)
    fits = fitting_routes(C, binv, b, x, shape, r, nF)
    for form, (from_zero, with_residual) in FORMS.items():
        start = None if from_zero else x
        bnd = bound_call(shape, nF, NU, from_zero, with_residual, r, f64)
        per_pass = bound_passes(shape, nF, passes_of(NU, from_zero,
                                                     with_residual), r,
                                f64)[0]
        for route in fits:
            fn = partial(sk._smooth_cuda, route, C, binv, b, start, 0.67,
                         NU, shape, r, nF, with_residual)
            is_main = main_smooth and route == routed and form == "pre"
            rows.append(time_kernel(
                "smooth_call" if route == routed else "smooth_other_route",
                key, fn,
                partial(sk.smooth_plain, C, binv, b, start, 0.67, NU,
                        shape, r, with_residual) if is_main else None,
                bound_=bnd, radius=r, f64=f64, per_pass_bound_ms=per_pass,
                form=form, **tag,
                route=ROUTES[route],
                launches_per_call=(
                    1 if route != sk.PER_PASS
                    else NU - (from_zero and NU >= 2) + with_residual)))
    return rows


def phase_kernels():
    import numpy as np
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    worst = {}
    check_no_spill_2d()

    def operands(shape, radius):
        m = 2 * radius + 1
        n = shape[0] * shape[1]
        C = torch.tensor(rng.standard_normal((m * m, *shape)),
                         dtype=torch.float32, device=dev)
        x = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
        return C, x, n

    for shape in [(17, 17), (33, 129), (40, 200)]:
        for radius in (1, 2):
            C, x, _ = operands(shape, radius)
            _check(worst, "stencil_mv", sk.stencil_mv(C, x, shape, radius),
                   sk.stencil_mv_plain(C, x, shape, radius), shape, radius)
    for shape in [(21, 35), (1025, 1025)]:
        C, x, n = operands(shape, 2)
        b = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
        invd = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                            device=dev)
        if shape == (1025, 1025):
            _check(worst, "stencil_mv", sk.stencil_mv(C, x, shape, 2),
                   sk.stencil_mv_plain(C, x, shape, 2), shape, 2)
        _check(worst, "jacobi_smooth",
               sk.jacobi_smooth(C, invd, b, x, 0.67, shape, 2),
               sk.jacobi_smooth_plain(C, invd, b, x, 0.67, shape, 2), shape,
               2)
    # the block entries: 1 to 3 fields (0: scalar planes), r = 1, 2,
    # ν = 1, 2, 3, from x and from zero, with and without the residual, by
    # every route, at odd shapes; then r = 2, ν = NU in the V-cycle's two
    # forms at every level shape
    bitwise = True
    all_forms = [(z, w) for z in (False, True) for w in (False, True)]
    for shape in [(17, 17), (33, 129), (40, 200)]:
        for radius in (1, 2):
            for n_fields in (0, 1, 2, 3):
                bitwise &= check_level_entries(
                    worst, rng, shape, radius, n_fields, dev, (1, 2, 3),
                    all_forms)
    level_sets = ((0, LEVELS2), (N_FIELDS_EL, BLOCK_SMOOTHED),
                  (N_FIELDS_NS, BLOCK_SMOOTHED))
    for n_fields, shapes in level_sets:
        for shape in shapes:
            bitwise &= check_level_entries(
                worst, rng, shape, 2, n_fields, dev, (NU,),
                list(FORMS.values()))
    phase("kernel_check", kernel="smooth",
          fused_bitwise_equal_per_pass=bitwise)

    rows = []
    for shape in LEVELS2:
        C, x, n = operands(shape, 2)
        b = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev)
        invd = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                            device=dev)
        main = shape == LEVELS2[0]

        def mv(C=C, x=x, shape=shape, f=sk.stencil_mv):
            return f(C, x, shape, 2)

        def jac(C=C, x=x, b=b, invd=invd, shape=shape, f=sk.jacobi_smooth):
            return f(C, invd, b, x, 0.67, shape, 2)

        rows.append(time_kernel(
            "stencil_mv", shape, mv,
            partial(mv, f=sk.stencil_mv_plain) if main else None,
            library=csr_call(C, shape, 2, x) if main else None))
        rows.append(time_kernel(
            "jacobi_smooth", shape, jac,
            partial(jac, f=sk.jacobi_smooth_plain) if main else None))
        del C, x, b, invd
    for shape in BLOCK_EXTRA:
        C, x, _ = operands(shape, 2)
        rows.append(time_kernel(
            "stencil_mv", shape,
            partial(sk.stencil_mv, C, x, shape, 2)))
    # the largest level whose smoothing call is one launch gives the
    # summary's "smooth" row
    fused = [sh for sh in LEVELS2
             if sk._smooth_route(sh, 2, 1, 0) != sk.PER_PASS]
    if not fused:
        fail("no scalar level's smoothing call is routed to one launch")
    # the three-field instances' summary rows: the block apply and the
    # sweep pass at the finest level, the fused call at the largest level
    # the plan gives one launch
    fused3 = [sh for sh in BLOCK_SMOOTHED
              if sk._smooth_route(sh, 2, N_FIELDS_NS, 0) != sk.PER_PASS]
    if not fused3:
        fail("no three-field level's smoothing call is routed to one launch")
    for n_fields, shapes in level_sets:
        for shape in shapes:
            rows += time_level(
                rng, shape, n_fields, dev,
                main_block=(n_fields in (N_FIELDS_EL, N_FIELDS_NS)
                            and shape == BLOCK_SMOOTHED[0]),
                main_smooth=(n_fields, shape) in ((0, fused[0]),
                                                  (N_FIELDS_NS, fused3[0])))
    return worst, (rows + kernels_r3(worst, rng, dev)
                   + kernels_r4(worst, rng, dev)
                   + kernels_r5(worst, rng, dev))


def built_instances(prefixes) -> list:
    """Registers, spill and stack of every built kernel whose name starts
    with one of ``prefixes``, from the compiler's report beside the
    library."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    return [{k: row.get(k) for k in ("kernel", "registers", "spill_stores",
                                     "spill_loads", "stack")}
            for row in ptxas_report(sk.library_path().with_suffix(
                ".log").read_text())
            if row["kernel"].startswith(prefixes)]


def check_no_spill_2d():
    """Every stencil2d.cuh instance (the pass kernel's 24 instances x 4
    passes, the level kernel's 24: f32 and f64, r = 1-4, 1-3 fields) built
    without spill."""
    instances = built_instances(("pass_kernel", "level_kernel"))
    phase("kernel_check", kernel="2D instances", ptxas=instances)
    if len(instances) != 120 or any(
            r["spill_stores"] or r["spill_loads"] for r in instances):
        fail(f"the 2D instances are not all built without spill: "
             f"{instances}")


def kernels_r3(worst, rng, dev):
    """The biharmonic's instances: radius 3 (49 taps) in f32 and f64, and
    the f64 instances at r = 1, 2. stencil_mv, jacobi_smooth,
    stencil_mv_block and smooth by every route against their plain
    versions (f32 TOL, f64 TOL64) at odd shapes (ν = 1–3, every form) and,
    r = 3, at every level shape of the n_bg = 511 hierarchy (ν = NU in the
    V-cycle's two forms); then device, call and bound times of the r = 3
    instances at the smoothed levels. Returns the ``kernel_time`` rows."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    all_forms = [(z, w) for z in (False, True) for w in (False, True)]
    bitwise = True
    for dt in (torch.float32, torch.float64):
        radii = (1, 2, 3) if dt == torch.float64 else (3,)
        cases = [(sh, r, (1, 2, 3), all_forms) for sh in ODD_SHAPES
                 for r in radii]
        cases += [(sh, 3, (NU,), list(FORMS.values()))
                  for sh in LEVELS_BH + [DENSE_BH]]
        for shape, radius, sweeps, forms in cases:
            bitwise &= check_level_entries(worst, rng, shape, radius, 0, dev,
                                           sweeps, forms, dt)
            C, binv, b, x = level_operands(rng, shape, radius, 0, dev, dt)
            _check(worst, "stencil_mv", sk.stencil_mv(C, x, shape, radius),
                   sk.stencil_mv_plain(C, x, shape, radius), shape, radius,
                   quiet=True)
            _check(worst, "jacobi_smooth",
                   sk.jacobi_smooth(C, binv, b, x, 0.67, shape, radius),
                   sk.jacobi_smooth_plain(C, binv, b, x, 0.67, shape,
                                          radius), shape, radius, quiet=True)
    phase("kernel_check", kernel="radius 3 and f64 instances",
          worst={k: v for k, v in worst.items() if "/" in k},
          fused_bitwise_equal_per_pass=bitwise)

    rows = []
    for dt in (torch.float32, torch.float64):
        f64 = dt == torch.float64
        fused = [sh for sh in LEVELS_BH
                 if sk._smooth_route(sh, 3, 1, 0, f64) != sk.PER_PASS]
        if not fused:
            fail(f"no radius-3 {dt} level's smoothing call is routed to one "
                 "launch")
        for shape in LEVELS_BH:
            C, binv, b, x = level_operands(rng, shape, 3, 0, dev, dt)
            main = shape == LEVELS_BH[0]
            rows.append(time_kernel(
                "stencil_mv", shape, partial(sk.stencil_mv, C, x, shape, 3),
                partial(sk.stencil_mv_plain, C, x, shape, 3) if main
                else None, radius=3, f64=f64,
                library=csr_call(C, shape, 3, x) if main else None))
            rows.append(time_kernel(
                "jacobi_smooth", shape,
                partial(sk.jacobi_smooth, C, binv, b, x, 0.67, shape, 3),
                partial(sk.jacobi_smooth_plain, C, binv, b, x, 0.67, shape,
                        3) if main else None, radius=3, f64=f64))
            del C, binv, b, x
            rows += time_level(rng, shape, 0, dev, main_block=main,
                               main_smooth=shape == fused[0], radius=3,
                               dtype=dt)
    return rows


# -- radius 4: the cubic B-spline background's instances ---------------------

# the cubic 2D elasticity's block instances, (f64, fields): its f64
# default route and its f32 mixed route on the 513² net
CUBIC_BLOCK2 = [(True, 2), (False, 2)]


def kernels_r4(worst, rng, dev):
    """The radius-4 (81-tap) 2D instances, f32 and f64, on scalar planes
    and 2 and 3 fields: stencil_mv, jacobi_smooth, stencil_mv_block and
    smooth by every route against their plain versions (f32 TOL, f64
    TOL64) at odd shapes (ν = 1, 3, every form) and, on the cubic paths, at
    every level of their cycles in the V-cycle's two forms (the f64
    biharmonic's 513² … 65² and its dense 33²; the elasticity's 2 × 513² …
    2 × 17², f64 and f32). Then device, call and bound times, with the
    plain versions', of each kernel the cubic 2D paths launch: at the
    finest level, the fused call at the largest level the plan gives one
    launch. Returns the ``kernel_time`` rows."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    f32, f64 = torch.float32, torch.float64
    all_forms = [(z, w) for z in (False, True) for w in (False, True)]
    bitwise = True
    for dt in (f32, f64):
        for sh in ODD_SHAPES:
            for n_fields in (0, 2, 3):
                bitwise &= check_level_entries(worst, rng, sh, 4, n_fields,
                                               dev, (1, 3), all_forms, dt)
            C, binv, b, x = level_operands(rng, sh, 4, 0, dev, dt)
            _check(worst, "stencil_mv", sk.stencil_mv(C, x, sh, 4),
                   sk.stencil_mv_plain(C, x, sh, 4), sh, 4, quiet=True)
            _check(worst, "jacobi_smooth",
                   sk.jacobi_smooth(C, binv, b, x, 0.67, sh, 4),
                   sk.jacobi_smooth_plain(C, binv, b, x, 0.67, sh, 4), sh,
                   4, quiet=True)
    for sh in LEVELS_BH + [DENSE_BH]:
        bitwise &= check_level_entries(worst, rng, sh, 4, 0, dev, (NU,),
                                       list(FORMS.values()), f64)
    for is64, nF in CUBIC_BLOCK2:
        for sh in BLOCK_SMOOTHED:
            bitwise &= check_level_entries(worst, rng, sh, 4, nF, dev, (NU,),
                                           list(FORMS.values()),
                                           f64 if is64 else f32)
        torch.cuda.empty_cache()
    phase("kernel_check", kernel="radius 4 instances",
          worst={k: v for k, v in worst.items() if "/r4" in k},
          fused_bitwise_equal_per_pass=bitwise)
    if not bitwise:
        fail("radius 4: a 2D fused smoothing call differs from its passes")

    rows = []
    top = LEVELS_BH[0]
    C, binv, b, x = level_operands(rng, top, 4, 0, dev, f64)
    rows.append(time_kernel(
        "stencil_mv", top, partial(sk.stencil_mv, C, x, top, 4),
        partial(sk.stencil_mv_plain, C, x, top, 4), radius=4, f64=True,
        library=csr_call(C, top, 4, x)))
    rows.append(time_kernel(
        "jacobi_smooth", top,
        partial(sk.jacobi_smooth, C, binv, b, x, 0.67, top, 4),
        partial(sk.jacobi_smooth_plain, C, binv, b, x, 0.67, top, 4),
        radius=4, f64=True))
    del C, binv, b, x
    fused = [sh for sh in LEVELS_BH
             if sk._smooth_route(sh, 4, 1, 0, True) == sk.GRID]
    rows += time_level(rng, top, 0, dev, main_block=True,
                       main_smooth=fused[:1] == [top], radius=4, dtype=f64)
    if fused and fused[0] != top:
        rows += time_level(rng, fused[0], 0, dev, main_block=False,
                           main_smooth=True, radius=4, dtype=f64)
    for is64, nF in CUBIC_BLOCK2:
        dt = f64 if is64 else f32
        fused = [sh for sh in BLOCK_SMOOTHED
                 if sk._smooth_route(sh, 4, nF, 0, is64) == sk.GRID]
        rows += time_level(rng, BLOCK_SMOOTHED[0], nF, dev, main_block=True,
                           main_smooth=False, radius=4, dtype=dt)
        if fused:
            rows += time_level(rng, fused[0], nF, dev, main_block=False,
                               main_smooth=True, radius=4, dtype=dt)
        torch.cuda.empty_cache()
    return rows


# -- radius 5 and above: the runtime-radius instances ------------------------

# the quartic 2D biharmonic's hierarchy (513² … 65² smoothed, 33² dense)
# and its 3D counterpart's on the 33³ net (33³, 17³ smoothed, 9³ dense)
LEVELS_QUARTIC3 = [(s_,) * 3 for s_ in (33, 17)]


def check_no_spill_rn():
    """Every runtime-radius instance built without spill: the 2D pass kernel
    (csrc/stencil_rn.cuh: f32 and f64 x 1-3 fields x apply, residual,
    sweep: 18) and level kernel (level2d_kernel: f32 and f64 x 1-3 fields:
    6), the 3D marching pass and level kernels (csrc/stencil3d.cuh
    march_rn_kernel, march_rn_level_kernel: f32 and f64 x 1-3 fields: 12)."""
    instances = built_instances(("pass2d_kernel", "level2d_kernel",
                                 "march_rn"))
    phase("kernel_check", kernel="runtime-radius instances",
          ptxas=instances)
    if len(instances) != 36 or any(
            r["spill_stores"] or r["spill_loads"] for r in instances):
        fail(f"the runtime-radius instances are not all built without "
             f"spill: {instances}")


def kernels_r5(worst, rng, dev):
    """The 2D runtime-radius instances at r = 5 (121 taps), f32 and f64, on
    scalar planes and 2 and 3 fields: stencil_mv, jacobi_smooth,
    stencil_mv_block and smooth (by one launch a pass and, where the
    level's tiles are co-resident, by the level kernel's one launch, which
    must equal the passes bitwise) against their plain versions (f32 TOL,
    f64 TOL64) at odd shapes (ν = 1, 3, every form) and, f64, at every
    level of the quartic biharmonic's cycle in the V-cycle's two forms
    (513² … 65² and the dense 33²); then device, call, bound, plain and
    library times of each kernel the quartic 2D path launches, at its
    finest level, and of the V-cycle's smoothing calls by each route at
    its smaller levels (the plain version at the largest the plan gives
    one launch). Returns the ``kernel_time`` rows."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    check_no_spill_rn()
    f32, f64 = torch.float32, torch.float64
    all_forms = [(z, w) for z in (False, True) for w in (False, True)]
    bitwise = True
    for dt in (f32, f64):
        for sh in ODD_SHAPES:
            for n_fields in (0, 2, 3):
                bitwise &= check_level_entries(worst, rng, sh, 5, n_fields,
                                               dev, (1, 3), all_forms, dt)
            C, binv, b, x = level_operands(rng, sh, 5, 0, dev, dt)
            _check(worst, "stencil_mv", sk.stencil_mv(C, x, sh, 5),
                   sk.stencil_mv_plain(C, x, sh, 5), sh, 5, quiet=True)
            _check(worst, "jacobi_smooth",
                   sk.jacobi_smooth(C, binv, b, x, 0.67, sh, 5),
                   sk.jacobi_smooth_plain(C, binv, b, x, 0.67, sh, 5), sh,
                   5, quiet=True)
    for sh in LEVELS_BH + [DENSE_BH]:
        bitwise &= check_level_entries(worst, rng, sh, 5, 0, dev, (NU,),
                                       list(FORMS.values()), f64)
    phase("kernel_check", kernel="radius 5 instances",
          worst={k: v for k, v in worst.items() if "/r5" in k})
    if not bitwise:
        fail("a radius-5 level's one launch differs from its passes")

    top = LEVELS_BH[0]
    C, binv, b, x = level_operands(rng, top, 5, 0, dev, f64)
    rows = [time_kernel(
        "stencil_mv", top, partial(sk.stencil_mv, C, x, top, 5),
        partial(sk.stencil_mv_plain, C, x, top, 5), radius=5, f64=True,
        library=csr_call(C, top, 5, x)), time_kernel(
        "jacobi_smooth", top,
        partial(sk.jacobi_smooth, C, binv, b, x, 0.67, top, 5),
        partial(sk.jacobi_smooth_plain, C, binv, b, x, 0.67, top, 5),
        radius=5, f64=True)]
    del C, binv, b, x
    rows += time_level(rng, top, 0, dev, main_block=True, main_smooth=False,
                       radius=5, dtype=f64)
    fused = [sh for sh in LEVELS_BH[1:]
             if sk._smooth_route(sh, 5, 1, dev.index or 0, True) == sk.GRID]
    for sh in LEVELS_BH[1:]:
        rows += time_level(rng, sh, 0, dev, main_block=False,
                           main_smooth=sh == fused[0], radius=5, dtype=f64)
    torch.cuda.empty_cache()
    return rows


N_BG3 = 104                      # 105³ = 1,157,625 background dofs
SHAPE3 = (N_BG3 + 1,) * 3
SOAK_ROUNDS = 400                # x 4 shapes x 3 kernels = 4,800 launches


def phase_kernels3():
    """The 3D kernels against their plain versions, a soak, and times."""
    import numpy as np
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    worst = {}

    def operands(shape, radius):
        m = 2 * radius + 1
        n = shape[0] * shape[1] * shape[2]

        def t(a):
            return torch.tensor(a, dtype=torch.float32, device=dev)

        return (t(rng.standard_normal((m ** 3, *shape))),
                t(rng.standard_normal(n)), t(rng.standard_normal(n)),
                t(rng.uniform(0.5, 2.0, n)), t(rng.standard_normal(n)))

    def check_cheb(C, x, b, invd, d, shape, radius, alpha, beta):
        d_in = None if beta == 0 else d.clone()
        y, d_out = sk.cheb_step3(C, invd, b, x, d_in, alpha, beta, shape,
                                 radius)
        y_ref, d_ref = sk.cheb_step3_plain(C, invd, b, x,
                                           None if beta == 0 else d,
                                           alpha, beta, shape, radius)
        _check(worst, "cheb_step3", y, y_ref, shape, radius, beta=beta)
        _check(worst, "cheb_step3", d_out, d_ref, shape, radius, beta=beta,
               what="d")

    for shape in [(9, 9, 9), (13, 10, 17), SHAPE3]:
        for radius in (1, 2):
            C, x, *_ = operands(shape, radius)
            _check(worst, "stencil_mv3", sk.stencil_mv3(C, x, shape, radius),
                   sk.stencil_mv3_plain(C, x, shape, radius), shape, radius)
            del C
    for shape in [(11, 9, 14), SHAPE3]:
        for radius in (1, 2):
            if shape == SHAPE3 and radius == 1:
                continue
            C, x, b, invd, d = operands(shape, radius)
            _check(worst, "jacobi_smooth3",
                   sk.jacobi_smooth3(C, invd, b, x, 0.67, shape, radius),
                   sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, shape,
                                           radius), shape, radius)
            check_cheb(C, x, b, invd, d, shape, radius, 1.7, 0.0)
            check_cheb(C, x, b, invd, d, shape, radius, 1.3, 0.45)
            del C

    # soak: the V-cycle's level shapes, interleaved, never synchronised
    # until the end; every repeat must reproduce its first result bitwise
    levels = [(s,) * 3 for s in (105, 53, 27, 14)]
    ops = [operands(sh, 2) for sh in levels]
    first = []
    for (C, x, b, invd, d), sh in zip(ops, levels):
        y0 = sk.stencil_mv3(C, x, sh, 2)
        j0 = sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, 2)
        c0, _ = sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, sh, 2)
        first.append((y0, j0, c0))
    mismatches = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for _ in range(SOAK_ROUNDS):
        for (C, x, b, invd, d), sh, (y0, j0, c0) in zip(ops, levels, first):
            mismatches += (sk.stencil_mv3(C, x, sh, 2) != y0).sum()
            mismatches += (sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, 2)
                           != j0).sum()
            mismatches += (sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, sh,
                                         2)[0] != c0).sum()
    torch.cuda.synchronize()
    soak_s = time.perf_counter() - t0
    for (C, x, b, invd, d), sh, (y0, j0, c0) in zip(ops, levels, first):
        _check(worst, "stencil_mv3", y0, sk.stencil_mv3_plain(C, x, sh, 2),
               sh, 2, after="soak")
        _check(worst, "jacobi_smooth3", j0,
               sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, sh, 2), sh, 2,
               after="soak")
    phase("soak", launches=SOAK_ROUNDS * len(levels) * 3,
          shapes=[list(sh) for sh in levels], radius=2, seconds=soak_s,
          mismatches=int(mismatches))
    if int(mismatches) != 0:
        fail(f"soak: {int(mismatches)} values differ between repeats")
    del ops, first

    rows = []
    for sh in LEVELS3:
        C, x, b, invd, d = operands(sh, 2)
        main = sh == LEVELS3[0]

        def mv(C=C, x=x, sh=sh, f=sk.stencil_mv3):
            return f(C, x, sh, 2)

        def jac(C=C, x=x, b=b, invd=invd, sh=sh, f=sk.jacobi_smooth3):
            return f(C, invd, b, x, 0.67, sh, 2)

        def cheb(C=C, x=x, b=b, invd=invd, d=d, sh=sh, f=sk.cheb_step3):
            return f(C, invd, b, x, d, 1.3, 0.45, sh, 2)

        for name, fn, plain in (
                ("stencil_mv3", mv, sk.stencil_mv3_plain),
                ("jacobi_smooth3", jac, sk.jacobi_smooth3_plain),
                ("cheb_step3", cheb, sk.cheb_step3_plain)):
            rows.append(time_kernel(
                name, sh, fn, partial(fn, f=plain) if main else None,
                library=(csr_call(C, sh, 2, x)
                         if main and name == "stencil_mv3" else None)))
        del C, x, b, invd, d
    torch.cuda.empty_cache()
    rows += kernels3_block(worst, dev)
    rows += kernels3_r3(worst, dev)
    rows += kernels3_smooth(worst, dev)
    rows += kernels3_r4(worst, dev)
    rows += kernels3_r5(worst, dev)
    rows += kernels3_staging(worst, dev)
    return worst, rows


BLOCK3_MODES = ("apply", "residual", "sweep", "zero")
BLOCK3_SOAK_ROUNDS = 50          # x 4 shapes x 4 modes = 800 launches,
                                 # and the two smoothing calls a shape


def block3_operands(gen, shape, radius, n_fields, dev, dtype=None):
    """A diagonally dominant nF-field 3D operator made on the card
    (n_fields = 0: scalar planes and the flat 1/diag), its smoother
    blocks, b and x, in ``dtype`` (default f32)."""
    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops.stencil import StencilOperatorBlock3D

    dtype = dtype or torch.float32
    nF, m3 = max(n_fields, 1), (2 * radius + 1) ** 3
    C = torch.rand((nF, nF, m3, *shape), generator=gen, device=dev,
                   dtype=dtype).sub_(0.5).mul_(0.2)
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    n = nF * shape[0] * shape[1] * shape[2]
    b, x = (torch.randn(n, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    if n_fields == 0:
        C = C[0, 0].contiguous()
        return C, (1.0 / C[m3 // 2]).reshape(-1).contiguous(), b, x
    return C, multigrid._point_binv(StencilOperatorBlock3D(C, shape,
                                                           radius)), b, x


def block3_calls(C, binv, b, x, shape, radius, omega=0.8, plain=False):
    """The four passes of stencil3d_block (or of its plain versions) as
    functions, keyed by mode."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    a = (shape, radius)
    if plain:
        return {
            "apply": partial(sk.apply3_block_plain, C, x, *a),
            "residual": partial(sk.residual3_block_plain, C, b, x, *a),
            "sweep": partial(sk.sweep3_block_plain, C, binv, b, x, omega, *a),
            "zero": partial(sk.sweep3_block_plain, C, binv, b, None, omega,
                            *a)}
    return {
        "apply": partial(sk.stencil3d_block, C, x, *a),
        "residual": partial(sk.stencil3d_block, C, x, *a, b=b),
        "sweep": partial(sk.stencil3d_block, C, x, *a, b=b, binv=binv,
                         omega=omega),
        "zero": partial(sk.stencil3d_block, C, None, *a, b=b, binv=binv,
                        omega=omega)}


def block3_library(C, b, x, shape, radius, mode, held):
    """The library yardstick of a block pass (as ``csr_call``'s): the apply
    and the residual have one, on one CSR form kept in ``held`` (a list
    the caller drops with the operands); the sweeps none (None)."""
    import torch

    if mode not in ("apply", "residual"):
        return None

    def make():
        if not held:
            held.append(planes_csr(C, shape, radius))
        if mode == "apply":
            return partial(torch.mv, held[0], x)
        return partial(torch.addmv, b, held[0], x, beta=1.0, alpha=-1.0)
    return make


def check_block3(worst, gen, shape, radius, n_fields, dev, dtype=None):
    """stencil3d_block's four passes at ``shape`` against the plain
    versions: one launch each, booked under its pass's name
    (``sk.PASS3_NAMES``); scalar planes also against stencil_mv3 and
    jacobi_smooth3. Prints one summary line."""
    from iifea_tpu_torch.ops import stencil_kernels as sk

    C, binv, b, x = block3_operands(gen, shape, radius, n_fields, dev,
                                    dtype)
    calls = block3_calls(C, binv, b, x, shape, radius)
    names = {mode: sk.PASS3_NAMES[mode, n_fields > 1] for mode in calls}
    before = sk.launches()
    got = {mode: fn() for mode, fn in calls.items()}
    if sk.launches() != {**before, **{k: before[k] + 1
                                      for k in names.values()}}:
        fail(f"stencil3d_block at {shape} was not one launch a pass, "
             f"counted under its name: {before} -> {sk.launches()}")
    refs = block3_calls(C, binv, b, x, shape, radius, plain=True)
    errs = [_check(worst, names[mode], got[mode], refs[mode](), shape,
                   radius, quiet=True, n_fields=n_fields, what=mode)
            for mode in calls]
    if n_fields == 0:
        errs.append(_check(worst, names["apply"], got["apply"],
                           sk.stencil_mv3(C, x, shape, radius), shape,
                           radius, quiet=True, what="apply vs stencil_mv3"))
        errs.append(_check(worst, names["sweep"], got["sweep"],
                           sk.jacobi_smooth3(C, binv, b, x, 0.8, shape,
                                             radius), shape, radius,
                           quiet=True, what="sweep vs jacobi_smooth3"))
    phase("kernel_check", kernel="stencil3d_block", shape=list(shape),
          radius=radius, n_fields=n_fields, checks=len(errs),
          dtype=str(C.dtype).replace("torch.", ""), max_abs_err=max(errs))


def kernels3_block(worst, dev):
    """The 3D block entry: checks, a soak, and ``kernel_time`` rows per
    pass, under the pass's name, at every level shape of the 3D block
    V-cycle for 3 and 2 fields (the plain versions' times at the finest
    level for 3 fields)."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(2)
    for shape in [(9, 9, 9), (13, 10, 17), (11, 9, 14)]:
        for radius in (1, 2):
            for n_fields in (0, 1, 2, 3):
                check_block3(worst, gen, shape, radius, n_fields, dev)
    for shape in BLOCK3_SMOOTHED:
        for n_fields in (0, N_FIELDS_EL3):
            check_block3(worst, gen, shape, 2, n_fields, dev)
        torch.cuda.empty_cache()

    # soak: the block V-cycle's level shapes, the four passes and the two
    # smoothing calls (one launch a call on the small levels), interleaved,
    # never synchronised until the end; every repeat must reproduce its
    # first result bitwise
    ops = []
    for sh in BLOCK3_SMOOTHED:
        C, binv, b, x = block3_operands(gen, sh, 2, N_FIELDS_EL3, dev)
        calls = block3_calls(C, binv, b, x, sh, 2)
        steps = [(1.0, 0.0)] * NU
        calls["call_pre"] = partial(
            lambda *a: torch.cat(sk.smooth3(*a, True)), C, binv, b, None,
            steps, sh, 2)
        calls["call_post"] = partial(sk.smooth3, C, binv, b, x, steps, sh, 2)
        ops.append(calls)
    first = [{mode: fn() for mode, fn in calls.items()} for calls in ops]
    mismatches = torch.zeros((), dtype=torch.int64, device=dev)
    before = sk.launches()
    t0 = time.perf_counter()
    for _ in range(BLOCK3_SOAK_ROUNDS):
        for calls, ref in zip(ops, first):
            for mode, fn in calls.items():
                mismatches += (fn() != ref[mode]).sum()
    torch.cuda.synchronize()
    after = sk.launches()
    phase("soak", kernel="stencil3d_block, smooth3",
          launches={k: after[k] - before[k] for k in after
                    if after[k] != before[k]},
          shapes=[[N_FIELDS_EL3, *sh] for sh in BLOCK3_SMOOTHED], radius=2,
          seconds=time.perf_counter() - t0, mismatches=int(mismatches))
    if int(mismatches) != 0:
        fail(f"stencil3d_block soak: {int(mismatches)} values differ "
             "between repeats")
    del ops, first
    torch.cuda.empty_cache()

    rows = []
    for n_fields in (N_FIELDS_EL3, 2):
        for sh in BLOCK3_SMOOTHED:
            C, binv, b, x = block3_operands(gen, sh, 2, n_fields, dev)
            calls = block3_calls(C, binv, b, x, sh, 2, omega=1.0)
            plain = block3_calls(C, binv, b, x, sh, 2, omega=1.0, plain=True)
            main = (n_fields, sh) == (N_FIELDS_EL3, BLOCK3_SMOOTHED[0])
            held = []
            for mode in BLOCK3_MODES:
                rows.append(time_kernel(
                    sk.PASS3_NAMES[mode, True], [n_fields, *sh],
                    calls[mode], plain[mode] if main else None,
                    bound_=bound_passes(sh, n_fields, [mode]),
                    plain_launches=2,
                    library=block3_library(C, b, x, sh, 2, mode, held)
                    if main else None))
            del C, binv, b, x, calls, plain, held
            torch.cuda.empty_cache()
    return rows


def scalar3_operands(gen, shape, radius, dtype, dev):
    """Scalar 3D planes with a dominant centre made on the card, their l1
    inverse diagonal (the 3D cycle's smoother scaling), b and x."""
    import torch

    m3 = (2 * radius + 1) ** 3
    C = torch.rand((m3, *shape), generator=gen, device=dev,
                   dtype=dtype).sub_(0.5).mul_(0.2)
    C[m3 // 2] += 4.0
    n = shape[0] * shape[1] * shape[2]
    invd = (1.0 / C.abs().sum(dim=0)).reshape(-1).contiguous()
    b, x = (torch.randn(n, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    return C, invd, b, x


def smooth3_paths():
    """The 3D paths' smoothed levels: (tag, fields (0: scalar planes),
    radius, dtype, Chebyshev, level shapes, the shape whose pre-smoothing
    call also times its plain version: a level the plan gives one launch,
    where the call is the level kernel's, or None)."""
    import torch

    return (
        ("elasticity3", N_FIELDS_EL3, 2, torch.float32, False,
         BLOCK3_SMOOTHED, BLOCK3_SMOOTHED[-1]),
        ("poisson3", 0, 2, torch.float32, True, LEVELS3, None),
        ("biharmonic3", 0, 3, torch.float64, True, LEVELS_BH3,
         LEVELS_BH3[-1]),
        ("biharmonic3_f32", 0, 3, torch.float32, True, LEVELS_BH3,
         LEVELS_BH3[-1]),
    )


def kernels3_smooth(worst, dev, paths=None, timed=True):
    """smooth3, a 3D level's smoothing call, at every level shape of the
    3D elasticity, Poisson and biharmonic cycles, in the V-cycle's two
    forms (NU steps from zero with the residual; NU from x), against its
    plain version: by one launch a pass, routed, and by one cooperative
    launch, which must launch where the plan's co-resident blocks hold the
    level and then equal the passes bitwise, and be refused where they do
    not. Then ``kernel_time`` rows of each form by
    each route that takes the level (``smooth3_call`` routed,
    ``smooth3_other_route``), the scalar call's step from zero (``zero3``,
    checked against its plain version) and its residual pass
    (``residual3``), with their plain versions' times at the finest level.
    ``paths``: those of ``smooth3_paths`` unless given; a path's main
    shape "fused" is its largest level the plan gives one launch; with
    ``timed`` False the checks alone. Returns the rows."""
    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for path, n_fields, r, dt, cheb, shapes, main in paths or smooth3_paths():
        f64 = dt == torch.float64
        nF = max(n_fields, 1)
        if main == "fused":
            main = next((sh for sh in shapes
                         if sk._plan3(sh, r, nF, dev.index or 0, f64)[1]),
                        None)
        steps = (multigrid.chebyshev_steps(NU, 8.0) if cheb
                 else [(1.0, 0.0)] * NU)
        for sh in shapes:
            C, binv, b, x = (
                block3_operands(gen, sh, r, n_fields, dev, dt) if n_fields
                else scalar3_operands(gen, sh, r, dt, dev))
            plan = sk._plan3(sh, r, nF, dev.index or 0, f64)
            # whether a launch of the level's blocks is co-resident
            runs = -(-sh[1] * sh[2] // (256 // plan[0]))
            fits = runs * sh[0] <= plan[2]
            key = list(sh) if n_fields == 0 else [nF, *sh]
            bitwise, errs = True, []
            for form, (from_zero, with_residual) in FORMS.items():
                start = None if from_zero else x
                args = (C, binv, b, start, steps, sh, r)
                ref = sk.smooth3_plain(*args, with_residual, cheb)
                per_pass = sk._smooth3_cuda(sk.PER_PASS, *args, nF,
                                            with_residual, cheb)
                routed = sk.smooth3(*args, with_residual, cheb)
                outs = [per_pass, routed]
                before = sk.smooth3.launches
                try:
                    # (the level launch stages every field's planes at
                    # r = 1-4, none from r = 5)
                    outs.append(sk._smooth3_cuda(
                        sk.GRID, *args, nF, with_residual, cheb,
                        split=plan[0],
                        staging=sk.UNSTAGED if r >= sk.RN_RADIUS
                        else sk.ALL_FIELDS))
                    fused = True
                except RuntimeError as e:
                    fused, why = False, str(e)
                if fused != fits:
                    fail(f"smooth3 {path} at {sh}: {fits=} by the plan "
                         f"{plan}, the fused launch "
                         + ("ran" if fused else f"was refused: {why}"))
                if sk.smooth3.launches - before != fused:
                    fail(f"smooth3 {path} at {sh}: a fused call made "
                         f"{sk.smooth3.launches - before} launches")
                for out in outs:
                    pairs = (zip(out, ref, (None, b)) if with_residual
                             else ((out, ref, None),))
                    for k, (v, v_ref, scale) in enumerate(pairs):
                        errs.append(_check(
                            worst, "smooth3", v, v_ref, sh, r, quiet=True,
                            scale=scale, form=form, n_fields=nF))
                        if k:   # the per-pass route's residual pass
                            _check(worst, sk.PASS3_NAMES["residual", nF > 1],
                                   v, v_ref, sh, r, quiet=True, scale=scale,
                                   n_fields=nF)
                        first = per_pass[k] if with_residual else per_pass
                        bitwise &= bool(torch.equal(v, first))
            phase("kernel_check", kernel="smooth3", path=path, shape=key,
                  radius=r, dtype="f64" if f64 else "f32", plan=list(plan),
                  routes=["per_pass", "routed"] + ["grid"] * fits,
                  max_abs_err=max(errs),
                  fused_bitwise_equal_per_pass=bitwise)
            if not bitwise:
                fail(f"smooth3 {path} at {sh}: the routes differ")
            routed = sk.GRID if plan[1] else sk.PER_PASS
            for form, (from_zero, with_residual) in FORMS.items():
                start = None if from_zero else x
                for route in ([sk.PER_PASS] + [sk.GRID] * fits) * timed:
                    is_main = (route == routed and form == "pre"
                               and sh == main)
                    rows.append(time_kernel(
                        "smooth3_call" if route == routed
                        else "smooth3_other_route", key,
                        partial(sk._smooth3_cuda, route, C, binv, b, start,
                                steps, sh, r, nF, with_residual, cheb,
                                split=plan[0]),
                        partial(sk.smooth3_plain, C, binv, b, start, steps,
                                sh, r, with_residual, cheb)
                        if is_main else None,
                        bound_=bound_call(sh, nF, NU, from_zero,
                                          with_residual, r, f64),
                        plain_launches=2, radius=r, f64=f64, form=form,
                        n_fields=nF, dim=3, path=path, route=ROUTES[route],
                        per_pass_bound_ms=bound_passes(
                            sh, nF, passes_of(NU, from_zero, with_residual),
                            r, f64)[0],
                        launches_per_call=(
                            1 if route == sk.GRID
                            else len(sk.passes3(NU, from_zero,
                                                with_residual)))))
            if n_fields == 0:
                # the scalar call's step from zero and its residual pass,
                # each under its own name
                zero = partial(sk._pass3, sk._ZERO, C, None, b, binv, sh, r,
                               1, omega0=steps[0][0])
                zero_plain = partial(sk.sweep3_block_plain, C, binv, b, None,
                                     steps[0][0], sh, r)
                _check(worst, "zero3", zero(), zero_plain(), sh, r,
                       quiet=True)
            if n_fields == 0 and timed:
                top = sh == shapes[0]
                rows.append(time_kernel(
                    "zero3", key, zero, zero_plain if top else None,
                    bound_=bound_passes(sh, 1, ["zero"], r, f64),
                    plain_launches=2, radius=r, f64=f64))
                rows.append(time_kernel(
                    "residual3", key,
                    partial(sk._pass3, sk._RESIDUAL, C, x, b, None, sh, r, 1),
                    partial(sk.residual3_block_plain, C, b, x, sh, r)
                    if top else None,
                    bound_=bound_passes(sh, 1, ["residual"], r, f64),
                    plain_launches=2, radius=r, f64=f64,
                    library=csr_call(C, sh, r, x, b) if top else None))
            del C, binv, b, x
            torch.cuda.empty_cache()
    return rows


N_BG = 1024                      # 1,050,625 background dofs (headline size)
MAX_CG_ITERS = 96                # 2x the reference's 48 iterations at n_bg=1024
MAX_CG_ITERS3 = 80               # 2x the reference's 40 iterations at n_bg=104


def fg_of(n_bg: int, dim: int = 2) -> int:
    """Foreground divisions: the fg/bg spacing ratio of the reference
    workloads (bench.py): sqrt(2) in 2D, 1.26 in 3D."""
    return int(n_bg * (1.4142 if dim == 2 else 1.26)) // 2 * 2


def sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def build_solver(n_bg: int, device, dim: int = 2):
    from iifea_tpu_torch.mesh import generators
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver

    gen = (generators.immersed_square_problem if dim == 2
           else generators.immersed_cube_problem)
    t0 = time.perf_counter()
    mesh, M = gen(n_fg=fg_of(n_bg, dim), n_bg=n_bg, device=device)
    t1 = time.perf_counter()
    mesh.facet_data
    t2 = time.perf_counter()
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=device)
    t3 = time.perf_counter()
    solver = BinnedLatticeSolver(prob, M, (n_bg + 1,) * dim, device=device)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    t4 = time.perf_counter()
    return mesh, M, prob, solver, {
        "problem": t1 - t0, "facet_data": t2 - t1, "PoissonProblem": t3 - t2,
        "BinnedLatticeSolver": t4 - t3}


def phase_small_reference():
    """Small problems against host references: at n_bg=64 (a 3-level
    V-cycle on the kernels) the card's solution has a host-measured f64
    residual below 1e-10; at n_bg=24 the card and host (plain versions)
    solutions agree on supported dofs to 1e-7·max(|u|, 1), the criterion
    of the JAX package's end-to-end test."""
    import torch

    from iifea_tpu_torch.ops import lattice_bin

    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    *_, s_gpu, _ = build_solver(64, gpu)
    *_, s_cpu, _ = build_solver(64, cpu)
    u_gpu, info = s_gpu.solve(rtol=1e-10)
    b, Kc, Kf = s_cpu.assemble()
    r = b - lattice_bin.apply_binned(s_cpu.reducers, s_cpu.bind(Kc, Kf),
                                     u_gpu.cpu())
    relres = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    phase("small_reference", n_bg=64, host_rel_residual=relres, **info)
    if not relres < 1e-10:
        fail(f"host-measured residual of the card's solution {relres}")

    *_, s_gpu, _ = build_solver(24, gpu)
    *_, s_cpu, _ = build_solver(24, cpu)
    u_gpu, info_gpu = s_gpu.solve(rtol=1e-10)
    u_cpu, info_cpu = s_cpu.solve(rtol=1e-10)
    b, Kc, Kf = s_cpu.assemble()
    d = s_cpu.probe(s_cpu.bind(Kc, Kf)).diag().abs() > 0
    lim = 1e-7 * max(float(u_cpu.abs().max()), 1.0)
    err = float((u_gpu.cpu() - u_cpu)[d].abs().max())
    phase("small_reference", n_bg=24, max_abs_diff=err, bound=lim,
          gpu=info_gpu, cpu=info_cpu)
    if not err <= lim:
        fail(f"card and host solves differ by {err}")
    *_, s_gpu, _ = build_solver(64, gpu)
    smoother_option(s_gpu, "small_reference", 64, smoother="chebyshev")


def smoother_option(solver, tag, n_bg, **option):
    """The solver's refinement loop to a 1e-8 f64 residual on the card with
    the default multigrid and with ``option`` (the other smoother of the
    lattice's multigrid class): both converge, the option within twice the
    default's iterations."""
    from iifea_tpu_torch.ops import multigrid

    cls = (multigrid.StencilMultigrid if solver.dim == 2
           else multigrid.StencilMultigrid3D)
    b64, Kc, Kf = solver.assemble()
    bound_ = solver.bind(Kc, Kf)
    S32 = solver.probe(bound_)
    out = {}
    for name, kw in (("default", {}), ("option", option)):
        _, relres, iters = solver.refine(S32, cls(S32, **kw), bound_, b64,
                                         1e-8)
        out[name] = {"cg_iters": iters, "rel_residual": relres}
    phase(tag, n_bg=n_bg, smoother_option=option, **out)
    if not all(v["rel_residual"] < 1e-8 for v in out.values()):
        fail(f"{tag}: smoother option {option} did not converge: {out}")
    if not out["option"]["cg_iters"] <= 2 * out["default"]["cg_iters"]:
        fail(f"{tag}: smoother option {option} takes more than twice the "
             f"default's iterations: {out}")


MAX_SINGLE_LEVEL_ITERS = 64      # 2x the host's 32 at 3D n_bg=8 (one level)


def phase_small_reference3():
    """3D small problems against host references: at n_bg=16 (17³ → 9³,
    Chebyshev sweeps on the kernels) the card's solution has a
    host-measured exact f64 residual below 1e-10; at n_bg=8 the card's and
    the host's (plain versions) solutions give the same L2/H10 errors to
    1e-8 relative (the JAX package's 3D end-to-end criterion: sliver-cut
    dofs are numerically undetermined, the foreground field is not)."""
    import torch

    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    *_, s_gpu, _ = build_solver(16, gpu, dim=3)
    *_, s_cpu, _ = build_solver(16, cpu, dim=3)
    u_gpu, info = s_gpu.solve(rtol=1e-10)
    b, Kc, Kf = s_cpu.assemble()
    _, _, relres = s_cpu.residual(s_cpu.bind(Kc, Kf), b, u_gpu.cpu())
    phase("small_reference3", n_bg=16, host_rel_residual=relres, **info)
    if not relres < 1e-10:
        fail(f"host-measured residual of the card's 3D solution {relres}")

    _, M_g, p_gpu, s_gpu, _ = build_solver(8, gpu, dim=3)
    _, M_c, p_cpu, s_cpu, _ = build_solver(8, cpu, dim=3)
    u_gpu, info_gpu = s_gpu.solve(rtol=1e-10)
    u_cpu, info_cpu = s_cpu.solve(rtol=1e-10)
    n_gpu = p_gpu.error_norms(M_g.mv(u_gpu))
    n_cpu = p_cpu.error_norms(M_c.mv(u_cpu))
    rel = {k: abs(n_gpu[k] - n_cpu[k]) / abs(n_cpu[k]) for k in ("L2", "H10")}
    phase("small_reference3", n_bg=8, norms_gpu=n_gpu, norms_cpu=n_cpu,
          rel_diff=rel, gpu=info_gpu, cpu=info_cpu)
    if not (info_gpu["rel_residual"] < 1e-10 and max(rel.values()) < 1e-8):
        fail(f"3D card and host solves differ: {rel}, {info_gpu}")
    # one 9³ level: the dense coarse inverse is the whole preconditioner
    if not info_gpu["cg_iters"] <= MAX_SINGLE_LEVEL_ITERS:
        fail(f"3D n_bg=8 on the card: {info_gpu['cg_iters']} CG iterations "
             f"> {MAX_SINGLE_LEVEL_ITERS} (host: {info_cpu['cg_iters']})")
    *_, s_gpu, _ = build_solver(16, gpu, dim=3)
    smoother_option(s_gpu, "small_reference3", 16, smoother="jacobi")


def on_cuda(solver, u, S32, mg) -> bool:
    tensors = [u, S32.coeffs, mg.coarse_inv, *mg.inv_diags,
               *(lv.coeffs for lv in mg.levels), solver.M.idxT,
               solver.M.valT]
    if solver.dim == 2:
        tensors += [solver.JinvT_b, solver.wdetT_b,
                    *(t for t in solver.rhs_tables.values() if t is not None)]
    for red in solver.reducers:
        tensors += [red.val_b, red.kappa, red.perm]
    for dom, _ in solver.prob.form.terms:
        tensors += [dom.eldofsT, dom.h]
    return all(t.is_cuda for t in tensors)


def profile_stats(solve) -> dict:
    """Device busy share and the top kernels of one warm ``solve()``, from
    torch.profiler (CUPTI); "not measured" if no device time shows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, wall = sync_time(solve)
    # kernel-level events only: op-level events carry the same device time
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in dev)
    if busy_us <= 0:
        return {"device_time": "not measured", "wall_seconds": wall}
    dev.sort(key=lambda e: -e[1])
    return {"wall_seconds": wall, "device_busy_seconds": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches": sum(c for *_, c in dev),
            "top": [{"name": k[:80], "seconds": t / 1e6, "count": c}
                    for k, t, c in dev[:10]]}


def profile_solve(solve, tag: str):
    """``profile_stats`` of one warm ``solve()`` on a line of its own.
    Returns the count of kernel launches (None when not measured)."""
    stats = profile_stats(solve)
    phase(tag, **stats)
    return stats.get("kernel_launches")


def stage_times(solver, tag: str):
    """Per-stage times of a warm solve (PERF.md's phases), synced per
    stage, and each stage's peak device memory."""
    import torch

    t_cg, t_res = [0.0], [0.0]
    cg0, res0 = solver.cg, solver.residual
    peak = {}

    def timed(fn, acc):
        def wrapped(*a):
            out, dt = sync_time(lambda: fn(*a))
            acc[0] += dt
            return out
        return wrapped

    def stage(name, fn):
        torch.cuda.reset_peak_memory_stats()
        out, dt = sync_time(fn)
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
        return out, dt

    solver.cg, solver.residual = timed(cg0, t_cg), timed(res0, t_res)
    try:
        (b64, Kc, Kf), t_asm = stage("assemble", solver.assemble)
        bound_, t_bind = stage("bind", lambda: solver.bind(Kc, Kf))
        S32, t_probe = stage("probe", lambda: solver.probe(bound_))
        mg, t_mg = stage("build_mg", lambda: solver.build_mg(S32))
        (x, relres, iters), t_ref = stage(
            "refine", lambda: solver.refine(S32, mg, bound_, b64, 1e-10))
    finally:
        # drop the instance attributes: a bound method stored on its own
        # instance is a reference cycle that would keep the solver (and
        # its tables) alive after the caller's del
        del solver.cg, solver.residual
    phase(tag, element_jacobians_rhs=t_asm, bind=t_bind,
          stencil_extraction=t_probe, multigrid_hierarchy=t_mg,
          refine=t_ref, refine_cg=t_cg[0], refine_residual=t_res[0],
          cg_iters=iters, rel_residual=relres, peak_gib=peak,
          levels=[list(lv.shape) for lv in mg.levels])
    return S32, mg


@contextlib.contextmanager
def count_by_shape(by_shape: Counter):
    """Count the stencil kernels' launches per lattice shape while the
    block runs. Every launch goes through a
    StencilOperator2D/3D/Block2D/Block3D method (``mv``, ``smooth``,
    ``jacobi_smooth``); each is called through a shim that reads the
    launch counters (``sk.launches()``: each kernel's, each 3D pass's under
    its own name) before and after the call and books the difference
    under the operator's shape (a block operator's led by its field count),
    ``kernel@shape``. A ``smooth`` call is also booked itself, by its form,
    as ``smooth_call@shape:pre`` (from zero, with the residual), ``:post``
    (from x, without) or ``:other`` (3D: ``smooth3_call@…``)."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.ops.stencil import (
        StencilOperator2D,
        StencilOperator3D,
        StencilOperatorBlock2D,
        StencilOperatorBlock3D,
    )

    def shim(name, method):
        def counted(self, *a, **kw):
            before = sk.launches()
            out = method(self, *a, **kw)
            shape = "x".join(map(str, (
                *([self.n_fields] if hasattr(self, "n_fields") else []),
                *self.shape)))
            shape += instance_tag(self.radius, self.dtype == torch.float64)
            for k, n in sk.launches().items():
                if n != before[k]:
                    by_shape[f"{k}@{shape}"] += n - before[k]
            if name == "smooth":
                call = ("smooth3_call" if len(self.shape) == 3
                        else "smooth_call")
                form = (a[2] is None, isinstance(out, tuple))
                by_shape[f"{call}@{shape}:" + next(
                    (k for k, v in FORMS.items() if v == form), "other")] += 1
            return out
        return counted

    saved = [(cls, name, cls.__dict__[name])
             for cls in (StencilOperator2D, StencilOperator3D,
                         StencilOperatorBlock2D, StencilOperatorBlock3D)
             for name in ("mv", "smooth", "jacobi_smooth")
             if name in cls.__dict__]
    for cls, name, method in saved:
        setattr(cls, name, shim(name, method))
    try:
        yield
    finally:
        for cls, name, method in saved:
            setattr(cls, name, method)


def counted_run(fn, names, tag):
    """fn() with every launch counter set to 0 just before and read just
    after; fails unless each kernel in ``names`` launched, and unless the
    per-shape counts add up to the wrappers' own counters. Returns
    (fn's result, seconds, launches by kernel, launches by kernel@shape)."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    by_shape = Counter()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launches()
    with count_by_shape(by_shape):
        out, seconds = sync_time(fn)
    counts = sk.launches()
    launches = {k: counts[k] for k in names}
    for k, n in counts.items():
        if sum(v for key, v in by_shape.items()
               if key.split("@")[0] == k) != n:
            fail(f"{tag}: per-shape launch counts of {k} do not add up "
                 f"to its counter {n}: {dict(by_shape)}")
    if min(launches.values()) <= 0:
        fail(f"{tag}: a kernel was not launched on the path: {launches}")
    return out, seconds, launches, dict(by_shape)


def drive(solver, names, max_iters: int, tag: str):
    """The main path once through the user entry point, counted."""
    import torch

    (u, info), t_first, launches, by_shape = counted_run(
        lambda: solver.solve(rtol=1e-10), names, tag)
    phase(tag, first_seconds=t_first, launches=launches,
          launches_by_shape=by_shape,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30, **info)
    if not info["rel_residual"] < 1e-10:
        fail(f"{tag}: relative f64 residual {info['rel_residual']} >= 1e-10")
    if not info["cg_iters"] <= max_iters:
        fail(f"{tag}: {info['cg_iters']} CG iterations > {max_iters}")
    if not (u.shape == (solver.M.n_bg_dofs,) and bool(torch.isfinite(u).all())):
        fail(f"{tag}: solution is not a finite vector of the background size")
    return u, launches, by_shape


def front_end(prob, M, u_ref, shape, methods, names, max_iters, tag):
    """The solver front-end on the main path's problem, as a user of the
    library drives it: ``assemble_background_system`` (generic jacfwd
    blocks), then ``solve_ksp(pc='mg')`` once per method, each counted.

    Each solve must reach an f64 relative residual below 1e-10, measured
    here through the general ``BackgroundOperator.mv``, within
    ``max_iters``, with every solver tensor on the card, and agree with the
    BinnedLatticeSolver's solution ``u_ref``:

    * max |x − u_ref| ≤ 1e-6·max|u_ref| over the supported dofs, those
      whose diagonal is at least 1e-3 of the largest. Dofs below that are
      cut to slivers: at a 1e-10 residual their values are not determined
      (at n_bg=1024 they reach 3e7 in u_ref while the solution is O(1)),
      and two Krylov methods legitimately leave different values there;
    * the L2/H10 errors of M x within 1e-6 relative, or within 1e-9 of
      u_exact's norm (ten times the solves' 1e-10 residual: the 2D L2
      error is 4.4e-6, so 1e-6 of it is below what the tolerance fixes).

    The phase line also carries the difference on every dof with a nonzero
    diagonal, per support threshold, and the L2 norm of the foreground
    field difference M(x − u_ref) relative to M u_ref."""
    import torch

    from iifea_tpu_torch.api import l2_norm
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers import ksp

    device_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                     device=u_ref.device)
    (A, b), t_asm = sync_time(
        lambda: assemble_background_system(prob.form, u0, M))
    reducers, t_tab = sync_time(lambda: ksp.lattice_tables(prob.form, M,
                                                           shape))
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    d = A.diag().abs()
    supported = d >= 1e-3 * d.max()
    lim = 1e-6 * float(u_ref[supported].abs().max())
    norms_ref = prob.error_norms(M.mv(u_ref))
    u_ref_l2 = l2_norm(M.mv(u_ref), prob.cell_dom)
    tensors = [b, *A.blocks, M.idxT, M.valT]
    for red in reducers:
        tensors += [red.val_b, red.kappa, red.perm]
    for method in methods:
        (x, info), t_solve, launches, by_shape = counted_run(
            lambda: ksp.solve_ksp(A, b, method=method, pc="mg", rtol=1e-10,
                                  lattice_shape=shape, monitor=False),
            names, f"{tag} {method}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        relres = float(torch.linalg.vector_norm(b - A.mv(x))
                       / torch.linalg.vector_norm(b))
        e = (x - u_ref).abs()
        diff = float(e[supported].max())
        by_support = {f"{t:g}": float(e[d > t * d.max()].max())
                      for t in (0.0, 1e-12, 1e-6, 1e-3, 5e-2)}
        field = l2_norm(M.mv(x - u_ref), prob.cell_dom) / u_ref_l2
        norms = prob.error_norms(M.mv(x))
        gap = {k: abs(norms[k] - norms_ref[k]) for k in ("L2", "H10")}
        phase(tag, method=method, pc="mg", rel_residual=relres,
              iters=info.iters, history=info.history,
              assemble_seconds=t_asm, tables_seconds=t_tab,
              solve_seconds=t_solve, device_gib_before=device_gib,
              setup_peak_gib=setup_peak, peak_gib=peak, launches=launches,
              launches_by_shape=by_shape, max_abs_diff=diff, bound=lim,
              diff_by_support=by_support, max_abs_u_ref=float(
                  u_ref.abs().max()), field_rel_diff=field,
              error_norms=norms, error_norms_binned=norms_ref,
              norms_rel_diff={k: gap[k] / norms_ref[k] for k in gap})
        if not relres < 1e-10:
            fail(f"{tag} {method}: f64 relative residual {relres} >= 1e-10")
        if not info.iters <= max_iters:
            fail(f"{tag} {method}: {info.iters} iterations > {max_iters}")
        if not all(t.is_cuda for t in [x, *tensors]):
            fail(f"{tag} {method}: a solver tensor is not on the card")
        if not diff <= lim:
            fail(f"{tag} {method}: differs from BinnedLatticeSolver by "
                 f"{diff} > {lim} on supported dofs")
        if not all(gap[k] <= 1e-6 * norms_ref[k] + 1e-9 for k in gap):
            fail(f"{tag} {method}: error norms {norms} differ from "
                 f"BinnedLatticeSolver's {norms_ref}")
    if F64_ON["on"] and len(shape) == 3:
        # the f64 route on the same system, the front-end's norm rule
        f64_route(tag, instance_tag(2, True),
                  lambda: ksp.solve_ksp(A, b, method="cg", pc="mg",
                                        rtol=1e-10, lattice_shape=shape,
                                        monitor=False, mixed=False),
                  A, b, names3(LEVELS3, 2, True), mixed_iters=info.iters,
                  iters_diff=MAX_ITERS_DIFF3, norms=field_norms(prob, M, x))
    general_probe(prob, M, A, b, norms_ref, shape, names, max_iters, tag)


BFR_TOL = 1e-9      # the parity tests' trim: zero and near-zero diagonals


def general_probe(prob, M, A, b, norms_ref, shape, names, max_iters, tag):
    """``solve_ksp(cg, pc='mg', bfr_tol=BFR_TOL)`` on the same system,
    counted: the BFR trim mask turns the binned/window assembly off, so the
    stencil planes come from the coloured general probe of ``A.mv_multi``
    (f64, in column chunks under ``ksp.PROBE_BUDGET_BYTES``) and the same
    kernels run the V-cycle. Gates: the probe ran, the trimmed system's
    f64 relative residual below 1e-10 within ``max_iters``, the solution
    on the card, and the error norms within 1e-6 relative (or 1e-9) of the
    binned solution's (the trimmed dofs carry no physical support)."""
    import torch

    from iifea_tpu_torch.solvers import ksp
    from iifea_tpu_torch.solvers.trim import apply_trim_rhs, trim_mask_from_diag

    mask = trim_mask_from_diag(A.diag(), BFR_TOL)
    At, bt = A.with_trim(mask), apply_trim_rhs(b, mask)
    stages = Counter()
    with timed_calls([(ksp, "_probe_general")], stages):
        (x, info), t_solve, launches, by_shape = counted_run(
            lambda: ksp.solve_ksp(A, b, method="cg", pc="mg", rtol=1e-10,
                                  bfr_tol=BFR_TOL, lattice_shape=shape,
                                  monitor=False),
            names, f"{tag} general probe")
    peak = torch.cuda.max_memory_allocated() / 2**30
    relres = rel_residual(At, bt, x)
    norms = prob.error_norms(M.mv(x))
    gap = {k: abs(norms[k] - norms_ref[k]) for k in ("L2", "H10")}
    phase(f"{tag}_general_probe", bfr_tol=BFR_TOL, trimmed=int(mask.sum()),
          columns=(2 * 2 + 1) ** len(shape),
          chunk=ksp._probe_chunk(A, torch.float64),
          probe_seconds=stages["_probe_general"], solve_seconds=t_solve,
          iters=info.iters, rel_residual=relres, peak_gib=peak,
          launches=launches, launches_by_shape=by_shape, error_norms=norms,
          norms_rel_diff={k: gap[k] / norms_ref[k] for k in gap})
    if not stages["_probe_general"] > 0:
        fail(f"{tag} general probe: the trimmed solve did not probe A")
    if not relres < 1e-10:
        fail(f"{tag} general probe: f64 relative residual {relres} >= 1e-10")
    if not info.iters <= max_iters:
        fail(f"{tag} general probe: {info.iters} iterations > {max_iters}")
    if not x.is_cuda:
        fail(f"{tag} general probe: the solution is not on the card")
    if not all(gap[k] <= 1e-6 * norms_ref[k] + 1e-9 for k in gap):
        fail(f"{tag} general probe: error norms {norms} differ from "
             f"BinnedLatticeSolver's {norms_ref}")


def phase_main_path():
    """Returns the kernel launch counts of one solve() at n_bg = N_BG."""
    import torch

    dev = torch.device("cuda", 0)
    mesh, M, prob, solver, setup = build_solver(N_BG, dev)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is enabled for f32 convolutions or matmuls")
    phase("setup", n_bg=N_BG, n_fg=fg_of(N_BG), n_bg_dofs=M.n_bg_dofs,
          n_cells=mesh.n_cells, n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem,
          tables=[list(r.meta) for r in solver.reducers], seconds=setup)

    names = ("stencil_mv", "jacobi_smooth", "stencil_mv_block", "smooth")
    u, launches, by_shape = drive(solver, names, MAX_CG_ITERS, "solve")
    S32, mg = stage_times(solver, "stages")
    if not on_cuda(solver, u, S32, mg):
        fail("a solver tensor is not on the card")

    profile_solve(lambda: solver.solve(rtol=1e-10), "profile")
    totals = []
    for _ in range(3):
        _, dt = sync_time(lambda: solver.solve(rtol=1e-10))
        totals.append(dt)
    norms = prob.error_norms(M.mv(u))
    phase("end_to_end", warm_seconds=totals, best=min(totals),
          error_norms=norms)
    if not all(v == v and 0 < v < 1e-2 for v in norms.values()):
        fail(f"error norms out of range: {norms}")
    del solver, S32, mg
    torch.cuda.empty_cache()
    front_end(prob, M, u, (N_BG + 1,) * 2, ("cg", "gmres"), names,
              MAX_CG_ITERS, "front_end")
    return launches, by_shape


def jacobi_option3(solver):
    """The 3D path's other smoother, ``StencilMultigrid3D(smoother=
    'jacobi')`` (l1-Jacobi ω-sweeps: the path of the scalar sweep pass,
    which the default Chebyshev cycle does not launch), through the
    solver's f32 MG-PCG refinement to a 1e-8 f64 residual on the same
    lattice, counted. Returns (launches by kernel, by shape)."""
    from iifea_tpu_torch.ops import multigrid

    b64, Kc, Kf = solver.assemble()
    bound_ = solver.bind(Kc, Kf)
    S32 = solver.probe(bound_)
    (_, relres, iters), seconds, launches, by_shape = counted_run(
        lambda: solver.refine(S32, multigrid.StencilMultigrid3D(
            S32, smoother="jacobi"), bound_, b64, 1e-8),
        ("stencil_mv3", "zero3", "jacobi_smooth3", "residual3"),
        "solve3_jacobi")
    phase("solve3_jacobi", smoother="jacobi", cg_iters=iters,
          rel_residual=relres, seconds=seconds, launches=launches,
          launches_by_shape=by_shape)
    if not relres < 1e-8:
        fail(f"solve3_jacobi: f64 relative residual {relres} >= 1e-8")
    return launches, by_shape


def phase_main_path3():
    """The 3D main path at n_bg = N_BG3, then the same lattice with the
    Jacobi smoother option (``jacobi_option3``); returns their kernel
    launch counts, added."""
    import torch

    dev = torch.device("cuda", 0)
    mesh, M, prob, solver, setup = build_solver(N_BG3, dev, dim=3)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is enabled for f32 convolutions or matmuls")
    phase("setup3", n_bg=N_BG3, n_fg=fg_of(N_BG3, 3), n_bg_dofs=M.n_bg_dofs,
          n_cells=mesh.n_cells, n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem,
          tables=[list(r.meta) for r in solver.reducers],
          table_bytes=[r.nbytes() for r in solver.reducers],
          device_gib=torch.cuda.memory_allocated() / 2**30, seconds=setup)

    names = names3(LEVELS3, 2, False)
    u, launches, by_shape = drive(solver, names, MAX_CG_ITERS3, "solve3")
    S32, mg = stage_times(solver, "stages3")
    if not on_cuda(solver, u, S32, mg):
        fail("a 3D solver tensor is not on the card")
    profile_solve(lambda: solver.solve(rtol=1e-10), "profile3")
    totals = []
    for _ in range(2):
        _, dt = sync_time(lambda: solver.solve(rtol=1e-10))
        totals.append(dt)
    norms = prob.error_norms(M.mv(u))
    del S32, mg
    jacobi_launches, jacobi_by_shape = jacobi_option3(solver)
    launches = {k: launches.get(k, 0) + jacobi_launches.get(k, 0)
                for k in {*launches, *jacobi_launches}}
    by_shape = Counter(by_shape) + Counter(jacobi_by_shape)
    del solver
    torch.cuda.empty_cache()
    front_end(prob, M, u, SHAPE3, ("cg",), names, MAX_CG_ITERS3,
              "front_end3")
    del u, prob, M, mesh
    torch.cuda.empty_cache()

    _, M52, p52, s52, _ = build_solver(52, dev, dim=3)
    u52, info52 = s52.solve(rtol=1e-10)
    norms52 = p52.error_norms(M52.mv(u52))
    phase("end_to_end3", warm_seconds=totals, best=min(totals),
          error_norms=norms, error_norms_n_bg52=norms52, n_bg52=info52)
    if not all(v == v and 0 < v < norms52[k] for k, v in norms.items()):
        fail(f"3D error norms {norms} not below n_bg=52's {norms52}")
    return launches, by_shape


def phase_demo():
    """The Poisson demo on the card (the ``main`` of ``python3 -m
    iifea_tpu_torch.demos.poisson --ref 4 --solv gmres --pc jacobi``, in
    this process: the general gather-bound A.mv and the exact A.diag, no
    stencil kernel), held against the same demo on the host: the card's
    GMRES must reach the host run's tolerance, and the L2/H10/H1 errors
    agree to 1e-6 relative."""
    poisson_demo(["--ref", "4", "--solv", "gmres", "--pc", "jacobi"],
                 "demo")


def phase_demo_p2():
    """The Poisson demo with P2 spaces (``--k 2 --ref 2``, n_fg = 32 on a
    P2 background of n_bg = 16; GMRES + Jacobi, no stencil kernel) on the
    card against the same demo on the host, as ``phase_demo``."""
    poisson_demo(["--k", "2", "--ref", "2", "--solv", "gmres", "--pc",
                  "jacobi"], "demo_p2")


def poisson_demo(argv, tag):
    """``iifea_tpu_torch.demos.poisson``'s ``main(argv)`` (what ``python3 -m
    iifea_tpu_torch.demos.poisson`` runs) in this process on the card
    against the same demo on the host."""
    import io

    from iifea_tpu_torch.demos import poisson as demo

    out, wall, launched, peak = demo_in_process(demo, argv, "cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        host = demo.main(argv + ["--device", "cpu"])
    tol = max(1e-8 * host["info"].history[0], 1e-9)
    norms = out["norms"]
    rel = {k: abs(norms[k] - host["norms"][k]) / host["norms"][k]
           for k in norms}
    resnorm = float(out["info"].resnorm)
    phase(tag, argv=argv, seconds=wall, iters=out["info"].iters,
          resnorm=resnorm, tol=tol, error_norms=norms,
          host_iters=host["info"].iters, host_error_norms=host["norms"],
          norms_rel_diff=rel, launches=launched, peak_gib=peak)
    if not (out["u_p"].is_cuda and resnorm <= tol):
        fail(f"{tag}: GMRES residual {resnorm} above {tol}, or not on the "
             "card")
    if not max(rel.values()) <= 1e-6:
        fail(f"{tag}: card norms {norms} differ from the host's "
             f"{host['norms']}")


N_BG_EL = 512                    # bench.py --workload elasticity's default
MAX_CG_ITERS_EL = 136            # 2x the reference's 68 iterations at 512


def build_elasticity(n_bg: int, device, dim: int = 2):
    """bench.py's elasticity workload at ``n_bg``: the immersed square with
    n_fg = 2·n_bg and two fields, or (dim = 3) the immersed cube with the 3D
    workloads' fg/bg ratio 1.26 and three fields;
    ImmersedElasticityProblem(k=1, sym=True), assembled by the generic
    front-end at u = 0. Returns (prob, M, A, b, seconds per stage)."""
    import torch

    from iifea_tpu_torch.mesh import generators
    from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system

    t0 = time.perf_counter()
    if dim == 2:
        mesh, M = generators.immersed_square_problem(
            n_fg=2 * n_bg, n_bg=n_bg, n_fields=2, device=device)
    else:
        mesh, M = generators.immersed_cube_problem(
            n_fg=fg_of(n_bg, 3), n_bg=n_bg, n_fields=3, device=device)
    mesh.facet_data
    t1 = time.perf_counter()
    prob = ImmersedElasticityProblem(mesh, k=1, sym=True, device=device)
    t2 = time.perf_counter()
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    (A, b), t_asm = sync_time(
        lambda: assemble_background_system(prob.form, u0, M))
    return prob, M, A, b, {"problem": t1 - t0, "ImmersedElasticityProblem":
                           t2 - t1, "assemble": t_asm}


def el_solve(A, b, n_bg, dim: int = 2, **kw):
    from iifea_tpu_torch.solvers import ksp

    kw = {"method": "cg", "pc": "mg", "rtol": 1e-10, **kw}
    if kw["pc"] == "mg":
        kw["lattice_shape"] = (n_bg + 1,) * dim
    return ksp.solve_ksp(A, b, n_fields=dim, monitor=False, **kw)


def rel_residual(A, b, x) -> float:
    import torch

    return float(torch.linalg.vector_norm(b - A.mv(x))
                 / torch.linalg.vector_norm(b))


@contextlib.contextmanager
def timed_calls(targets, acc: Counter):
    """Replace each (module, name) by a wrapper that adds its synced
    seconds to acc[name] while the block runs."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(fn, name):
        def timed(*a, **kw):
            out, dt = sync_time(lambda: fn(*a, **kw))
            acc[name] += dt
            return out
        return timed

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn, name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_on_card(counts: Counter):
    """Count the plain stencil applies (``stencil_mv_plain`` and
    ``stencil_mv3_plain``, through which every plain 2D and 3D apply goes)
    on card tensors while the block runs, split into those inside the
    coarsest level's dense inverse (scalar or block; set-up: the
    identity's columns through ``mv_ref``, as the reference does) and all
    others."""
    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops import stencil_kernels as sk

    plains = {"stencil_mv_plain": sk.stencil_mv_plain,
              "stencil_mv3_plain": sk.stencil_mv3_plain}
    denses = {name: getattr(multigrid, name)
              for name in ("_dense_inverse", "_dense_inverse3",
                           "_dense_inverse_block")}
    where = ["elsewhere"]

    def counting(plain):
        def counted_plain(C, x, *a, **kw):
            if x.is_cuda:
                counts[where[0]] += 1
            return plain(C, x, *a, **kw)
        return counted_plain

    def counted_dense(dense):
        def counted(S):
            where[0] = "dense_inverse"
            try:
                return dense(S)
            finally:
                where[0] = "elsewhere"
        return counted

    for name, plain in plains.items():
        setattr(sk, name, counting(plain))
    for name, dense in denses.items():
        setattr(multigrid, name, counted_dense(dense))
    try:
        yield
    finally:
        for name, plain in plains.items():
            setattr(sk, name, plain)
        for name, dense in denses.items():
            setattr(multigrid, name, dense)


def phase_elasticity():
    """The block path: small references against host SuperLU, then the
    n_bg = N_BG_EL solve counted, staged, profiled, and its error norms
    against an n_bg=256 solve's. Returns its launch counts."""
    import math

    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.solvers import ksp

    dev = torch.device("cuda", 0)

    # -- n_bg=64 against host LU (the JAX spec test_models.py:168-190) ------
    prob, M, A, b, _ = build_elasticity(64, dev)
    u_lu, _ = el_solve(A, b, 64, method="direct")
    n_lu = prob.error_norms(M.mv(u_lu))
    for pc, rtol in (("mg", 1e-11), ("bjacobi", 1e-12)):
        (u, info), dt = sync_time(lambda: el_solve(A, b, 64, pc=pc,
                                                   rtol=rtol))
        norms = prob.error_norms(M.mv(u))
        rel = {k: abs(norms[k] - n_lu[k]) / n_lu[k] for k in n_lu}
        phase("elasticity_small", n_bg=64, pc=pc, rtol=rtol,
              iters=info.iters, rel_residual=rel_residual(A, b, u),
              seconds=dt, error_norms=norms, error_norms_lu=n_lu,
              norms_rel_diff=rel)
        if not (u.is_cuda and max(rel.values()) <= 1e-8):
            fail(f"elasticity n_bg=64 pc={pc}: norms {norms} differ from "
                 f"host LU's {n_lu} by {rel}")
    del prob, M, A, b, u_lu, u

    # -- the main path at n_bg = N_BG_EL --------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, A, b, setup = build_elasticity(N_BG_EL, dev)
    phase("elasticity_setup", n_bg=N_BG_EL, n_fg=2 * N_BG_EL,
          n_bg_dofs=M.n_bg_dofs, n_cells=prob.mesh.n_cells,
          n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem, seconds=setup,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    names = ("stencil_mv_block", "jacobi_smooth", "smooth")
    plain = Counter()
    with plain_on_card(plain):
        (u, info), t_first, launches, by_shape = counted_run(
            lambda: el_solve(A, b, N_BG_EL), names, "elasticity")
    relres = rel_residual(A, b, u)
    norms = prob.error_norms(M.mv(u))
    phase("elasticity", first_seconds=t_first, iters=info.iters,
          passes=len(info.history) - 1, history=info.history,
          rel_residual=relres, error_norms=norms, launches=launches,
          launches_by_shape=by_shape, plain_applies_on_card=dict(plain),
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not relres < 1e-10:
        fail(f"elasticity: f64 relative residual {relres} >= 1e-10")
    if not info.iters <= MAX_CG_ITERS_EL:
        fail(f"elasticity: {info.iters} CG iterations > {MAX_CG_ITERS_EL}")
    if not (u.shape == (M.n_bg_dofs,) and u.is_cuda
            and bool(torch.isfinite(u).all())):
        fail("elasticity: the solution is not a finite card vector of the "
             "background size")
    missing = [s_ for s_ in BLOCK_SMOOTHED if not any(
        by_shape.get(f"{k}@{N_FIELDS_EL}x{s_[0]}x{s_[1]}", 0) > 0
        for k in names)]
    if missing:
        fail(f"elasticity: no stencil launch at the smoothed shapes "
             f"{missing}: {by_shape}")
    if not sum(launches.values()) <= MAX_STENCIL_LAUNCHES_EL:
        fail(f"elasticity: {sum(launches.values())} stencil launches per "
             f"solve > {MAX_STENCIL_LAUNCHES_EL}: {launches}")
    if plain["elsewhere"]:
        fail(f"elasticity: {plain['elsewhere']} plain stencil applies on "
             "the card outside the coarse dense inverse")

    # stages of a warm solve: probe, hierarchy, deflation, Krylov + refine
    stages = Counter()
    torch.cuda.reset_peak_memory_stats()
    with timed_calls([(ksp, "_probe_block"),
                      (multigrid, "StencilMultigridBlock"),
                      (ksp, "_deflation_space")], stages):
        (u2, info2), t_warm = sync_time(lambda: el_solve(A, b, N_BG_EL))
    peak = torch.cuda.max_memory_allocated() / 2**30
    hier = stages["StencilMultigridBlock"]
    phase("elasticity_stages", assemble=setup["assemble"],
          probe=stages["_probe_block"], hierarchy=hier,
          deflation=stages["_deflation_space"],
          solve=t_warm - sum(stages.values()), solve_ksp=t_warm,
          iters=info2.iters, rel_residual=rel_residual(A, b, u2),
          peak_gib=peak)
    n_all = profile_solve(lambda: el_solve(A, b, N_BG_EL),
                          "elasticity_profile")
    if n_all is not None and not n_all <= MAX_LAUNCHES_EL:
        fail(f"elasticity: {n_all} kernel launches in the profiled solve > "
             f"{MAX_LAUNCHES_EL}")
    del u2
    if F64_ON["on"]:
        f64_route("elasticity", instance_tag(2, True, N_FIELDS_EL),
                  lambda: el_solve(A, b, N_BG_EL, mixed=False), A, b,
                  block_names(2, BLOCK_SMOOTHED, 2, N_FIELDS_EL, True),
                  mixed_iters=info.iters, iters_diff=MAX_ITERS_DIFF_EL,
                  norms=field_norms(prob, M, u))
    del A, b
    torch.cuda.empty_cache()

    # -- convergence: below the n_bg=256 solve's errors, L2 rate > 1.5 ------
    p256, M256, A256, b256, _ = build_elasticity(N_BG_EL // 2, dev)
    u256, info256 = el_solve(A256, b256, N_BG_EL // 2)
    n256 = p256.error_norms(M256.mv(u256))
    rate = math.log2(n256["L2"] / norms["L2"])
    phase("elasticity_convergence", error_norms=norms,
          error_norms_n_bg256=n256, l2_rate=rate, iters_n_bg256=info256.iters,
          rel_residual_n_bg256=rel_residual(A256, b256, u256))
    if not all(v == v and 0 < v < n256[k] for k, v in norms.items()):
        fail(f"elasticity: error norms {norms} not below n_bg=256's {n256}")
    if not rate > 1.5:
        fail(f"elasticity: L2 rate {rate} <= 1.5")
    return launches, by_shape


def phase_demo_elasticity():
    """The elasticity demo's ``main(argv)`` (what ``python3 -m
    iifea_tpu_torch.demos.linear_elasticity`` runs) in this process on the
    card (block-MG CG on the block stencil kernels), held against the same
    demo on the host: L2/H10 errors equal to 1e-8 relative."""
    import io

    from iifea_tpu_torch.demos import linear_elasticity as demo

    argv = ["--mesh-root", "synthetic", "--k", "1", "--ref", "3"]
    out, wall, launched, peak = demo_in_process(demo, argv, "cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        host = demo.main(argv + ["--device", "cpu"])
    norms = out["norms"]
    rel = {k: abs(norms[k] - host["norms"][k]) / host["norms"][k]
           for k in norms}
    phase("demo_elasticity", argv=argv, seconds=wall,
          iters=out["info"].iters, error_norms=norms,
          host_iters=host["info"].iters, host_error_norms=host["norms"],
          norms_rel_diff=rel, launches=launched, peak_gib=peak)
    if not (out["u_p"].is_cuda and out["info"].converged
            and max(rel.values()) <= 1e-8):
        fail(f"elasticity demo: card norms {norms} differ from the host's "
             f"{host['norms']}, or the card's solve did not converge")


def phase_elasticity3():
    """The 3D block path: small references against host SuperLU, then the
    n_bg = N_BG_EL3 solve counted per lattice shape and pass, staged,
    profiled, and its error norms against an n_bg=48 solve's. Returns its
    launch counts."""
    import math

    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.solvers import ksp

    dev = torch.device("cuda", 0)
    nF = N_FIELDS_EL3

    # -- n_bg = 8 (one dense 9³ level) and 16 against host LU ------------------
    for n_bg in (8, 16):
        prob, M, A, b, _ = build_elasticity(n_bg, dev, dim=3)
        u_lu, _ = el_solve(A, b, n_bg, dim=3, method="direct")
        n_lu = prob.error_norms(M.mv(u_lu))
        (u, info), dt = sync_time(lambda: el_solve(A, b, n_bg, dim=3))
        norms = prob.error_norms(M.mv(u))
        rel = {k: abs(norms[k] - n_lu[k]) / n_lu[k] for k in n_lu}
        phase("elasticity3_small", n_bg=n_bg, iters=info.iters,
              rel_residual=rel_residual(A, b, u), seconds=dt,
              error_norms=norms, error_norms_lu=n_lu, norms_rel_diff=rel)
        most = MAX_CG_ITERS_EL3_SINGLE if n_bg == 8 else MAX_CG_ITERS_EL3
        if not (u.is_cuda and info.iters < most
                and max(rel.values()) <= 1e-8):
            fail(f"3D elasticity n_bg={n_bg}: {info.iters} iterations, norms "
                 f"{norms} differ from host LU's {n_lu} by {rel}")
        del prob, M, A, b, u_lu, u

    # -- the main path at n_bg = N_BG_EL3 --------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, A, b, setup = build_elasticity(N_BG_EL3, dev, dim=3)
    phase("elasticity3_setup", n_bg=N_BG_EL3, n_fg=fg_of(N_BG_EL3, 3),
          n_bg_dofs=M.n_bg_dofs, n_cells=prob.mesh.n_cells,
          n_block_cells=prob.cell_dom.n_elem,
          n_facets=prob.facet_dom.n_elem, seconds=setup,
          probe_columns=nF * 125, probe_chunk=ksp._probe_chunk(
              A, torch.float64),
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    names = ("stencil3d_block", "smooth3")
    if not all(sk._plan3(sh, 2, nF, dev.index or 0)[1]
               for sh in BLOCK3_SMOOTHED):
        names += ("zero3_block", "sweep3_block", "residual3_block")
    plain = Counter()
    with plain_on_card(plain):
        (u, info), t_first, launches, by_shape = counted_run(
            lambda: el_solve(A, b, N_BG_EL3, dim=3), names, "elasticity3")
    relres = rel_residual(A, b, u)
    norms = prob.error_norms(M.mv(u))
    passes = len(info.history) - 1
    phase("elasticity3", first_seconds=t_first, iters=info.iters,
          passes=passes, history=info.history, rel_residual=relres,
          error_norms=norms, launches=launches, launches_by_shape=by_shape,
          plain_applies_on_card=dict(plain),
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not relres < 1e-10:
        fail(f"elasticity3: f64 relative residual {relres} >= 1e-10")
    if not info.iters <= MAX_CG_ITERS_EL3:
        fail(f"elasticity3: {info.iters} CG iterations > {MAX_CG_ITERS_EL3}")
    if not (u.shape == (M.n_bg_dofs,) and u.is_cuda
            and bool(torch.isfinite(u).all())):
        fail("elasticity3: the solution is not a finite card vector of the "
             "background size")
    # what the V-cycle's structure predicts: one V-cycle per CG iteration
    # and one per pass (the initial z = M r); per V-cycle and smoothed level
    # two smoothing calls, each one smooth3 launch where the plan holds the
    # level in one launch, else one launch a pass: the sweep from zero,
    # 2·NU − 1 sweeps and one residual; one apply per Krylov matvec
    # (iterations + one initial residual per pass) and one per field in the
    # deflation-space test, at the finest shape only
    cycles = info.iters + passes
    want = {}
    for sh in BLOCK3_SMOOTHED:
        shape = "x".join(map(str, (nF, *sh)))
        if sk._plan3(sh, 2, nF, dev.index or 0)[1]:
            want[f"smooth3@{shape}"] = 2 * cycles
            continue
        want.update({f"zero3_block@{shape}": cycles,
                     f"residual3_block@{shape}": cycles,
                     f"sweep3_block@{shape}": (2 * NU - 1) * cycles})
    want["stencil3d_block@" + "x".join(map(str, (nF, *BLOCK3_SMOOTHED[0])))
         ] = cycles + nF
    got = {k: v for k, v in by_shape.items()
           if k.startswith(("stencil3d_block@", "smooth3@", "zero3_block@",
                            "residual3_block@", "sweep3_block@"))}
    if got != want:
        fail(f"elasticity3: stencil3d_block and smooth3 launches {got} are "
             f"not what {cycles} V-cycles predict: {want}")
    if plain["elsewhere"]:
        fail(f"elasticity3: {plain['elsewhere']} plain stencil applies on "
             "the card outside the coarse dense inverse")

    stages = Counter()
    torch.cuda.reset_peak_memory_stats()
    with timed_calls([(ksp, "_probe_block"),
                      (multigrid, "StencilMultigridBlock3D"),
                      (ksp, "_deflation_space")], stages):
        (u2, info2), t_warm = sync_time(
            lambda: el_solve(A, b, N_BG_EL3, dim=3))
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("elasticity3_stages", assemble=setup["assemble"],
          probe=stages["_probe_block"],
          hierarchy=stages["StencilMultigridBlock3D"],
          deflation=stages["_deflation_space"],
          solve=t_warm - sum(stages.values()), solve_ksp=t_warm,
          iters=info2.iters, rel_residual=rel_residual(A, b, u2),
          peak_gib=peak)
    if not peak < 80 * 1e9 / 2**30:
        fail(f"elasticity3: peak device memory {peak} GiB")
    del u2
    profile_solve(lambda: el_solve(A, b, N_BG_EL3, dim=3),
                  "elasticity3_profile")
    if F64_ON["on"]:
        f64_route("elasticity3", instance_tag(2, True, nF, 3),
                  lambda: el_solve(A, b, N_BG_EL3, dim=3, mixed=False), A, b,
                  block_names(3, BLOCK3_SMOOTHED, 2, nF, True),
                  mixed_iters=info.iters, max_iters=MAX_CG_ITERS_EL3,
                  norms=field_norms(prob, M, u))
    del A, b
    torch.cuda.empty_cache()

    # -- convergence: below the n_bg=48 solve's errors, L2 rate > 1.5 --------
    p48, M48, A48, b48, _ = build_elasticity(N_BG_EL3 // 2, dev, dim=3)
    u48, info48 = el_solve(A48, b48, N_BG_EL3 // 2, dim=3)
    n48 = p48.error_norms(M48.mv(u48))
    rate = math.log2(n48["L2"] / norms["L2"])
    phase("elasticity3_convergence", error_norms=norms,
          error_norms_n_bg48=n48, l2_rate=rate, iters_n_bg48=info48.iters,
          rel_residual_n_bg48=rel_residual(A48, b48, u48))
    if not all(v == v and 0 < v < n48[k] for k, v in norms.items()):
        fail(f"elasticity3: error norms {norms} not below n_bg=48's {n48}")
    if not rate > 1.5:
        fail(f"elasticity3: L2 rate {rate} <= 1.5")
    return launches, by_shape


N_BG_NEWTON = 1024


def scalar_form(mesh, device, kind: str):
    """A nonlinear scalar form on the cut square's block, no boundary term:
    'diffusion' −∇·((1 + u²)∇u) + u = 1, or 'atan' −Δu + atan(u − 2) = 0
    (near-flat far field: full Newton steps overshoot)."""
    import torch

    from iifea_tpu_torch.mesh.core import FunctionSpace
    from iifea_tpu_torch.ops.assembly import Form, Term, build_cell_domain

    V = FunctionSpace(mesh, degree=1, n_fields=1)

    def kern(u_loc, aux_loc, ctx, params):
        uq = torch.einsum("qb,b->q", ctx.phi, u_loc[:, 0])
        gu = torch.einsum("qbd,b->qd", ctx.gphi, u_loc[:, 0])
        if kind == "diffusion":
            r = torch.einsum("q,q,qd,qbd->b", ctx.w, 1 + uq ** 2, gu,
                             ctx.gphi)
            react = uq - 1.0
        else:
            r = torch.einsum("q,qd,qbd->b", ctx.w, gu, ctx.gphi)
            react = torch.arctan(uq - 2.0)
        return (r + torch.einsum("q,q,qb->b", ctx.w, react, ctx.phi))[:, None]

    cells = (mesh.material == 2).nonzero()[0]
    return Form(V, [Term(build_cell_domain(V, cells, 3, device=device),
                         kern)])


def newton_run(n_bg, device, kind="diffusion", start=0.0, **kw):
    """``solve_nonlinear`` on the cut square at ``n_bg`` on ``device``, with
    every Newton step's assembly and linear-solve seconds, linear
    iterations and stencil launches recorded. Returns a dict; ``error`` is
    the NonlinearSolveError where one was raised."""
    import torch

    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.solvers import newton

    def timed(fn):
        if device.type == "cuda":
            return sync_time(fn)
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    mesh, M = immersed_square_problem(n_fg=fg_of(n_bg), n_bg=n_bg,
                                      device=device)
    form = scalar_form(mesh, device, kind)
    steps = []
    assemble, solve_ksp = form.jacobian_and_residual, newton.solve_ksp

    def timed_assemble(*a, **k):
        out, dt = timed(lambda: assemble(*a, **k))
        steps.append({"assemble_seconds": dt})
        return out

    def timed_solve(*a, **k):
        before = sum(sk.launches().values())
        (x, info), dt = timed(lambda: solve_ksp(*a, **k))
        steps[-1].update(
            residual_norm=float(torch.linalg.vector_norm(a[1])),
            solve_seconds=dt, launches=sum(sk.launches().values()) - before,
            linear_iters=None if info is None else info.iters)
        return x, info

    form.jacobian_and_residual = timed_assemble
    newton.solve_ksp = timed_solve
    u0 = torch.full((M.n_bg_dofs,), float(start), dtype=torch.float64,
                    device=device)
    out = {"M": M, "form": form, "steps": steps, "error": None}
    try:
        out["u_p"], out["u_f"] = newton.solve_nonlinear(
            form, M.mv(u0), M, u0, monitor_newton=False,
            **{"max_iters": 30, "relative_tolerance": 1e-8, **kw})
    except newton.NonlinearSolveError as e:
        out["error"] = e
    finally:
        newton.solve_ksp = solve_ksp
        del form.jacobian_and_residual
    r0 = M.rmv(assemble(M.mv(u0))[1])
    out["r0"] = float(torch.linalg.vector_norm(r0))
    if out["error"] is None:
        out["r"] = float(torch.linalg.vector_norm(
            M.rmv(form.residual(out["u_f"]))))
    return out


def phase_newton():
    """The Newton solvers on the card. ``solve_nonlinear(linear_method='cg',
    linear_pc='mg')`` on the nonlinear diffusion form at n_bg = N_BG_NEWTON:
    every step re-assembles (jacfwd) and re-solves on the hand kernels;
    gates: converged, the projected residual down to 1e-8 of the first,
    stencil launches in every step whose linear solve iterates. At n_bg=64: the host's Newton
    iteration count, and the ``linear_pc='jacobi'`` run's solution: the
    foreground field over the block in L2 to 1e-5 relative, and the
    iterate to 1e-5·max|u| on dofs with a diagonal of at least a tenth of
    the largest (this form has no boundary term, so background dofs that
    reach the block through the same few foreground nodes are determined
    only in combination, whatever their diagonal); the atan-reaction case (plain Newton
    raises NonlinearSolveError, ``line_search=True`` converges);
    ``solve_newtons_linear`` on Poisson with two supported dofs pinned to
    zero against the direct solve of the trimmed system (its residual, and
    the foreground field's error norms: the system is near-singular, so
    background values are not compared)."""
    import torch

    from iifea_tpu_torch.api import l2_norm
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.ops.projection import (
        BackgroundOperator,
        assemble_background_system,
    )
    from iifea_tpu_torch.solvers import ksp, newton, trim

    cpu, dev = torch.device("cpu"), torch.device("cuda", 0)
    mg = dict(linear_method="cg", linear_pc="mg")

    # -- n_bg = 64: the host's iteration count, the Jacobi run's iterate -------
    shape = (65, 65)
    runs = {"card_mg": newton_run(64, dev, lattice_shape=shape, **mg),
            "host_mg": newton_run(64, cpu, lattice_shape=shape, **mg),
            "card_jacobi": newton_run(64, dev, linear_method="cg",
                                      linear_pc="jacobi")}
    if any(r["error"] for r in runs.values()):
        fail(f"newton n_bg=64 did not converge: "
             f"{ {k: str(r['error']) for k, r in runs.items()} }")
    r = runs["card_mg"]
    blocks, _ = r["form"].jacobian_and_residual(r["u_f"])
    d = BackgroundOperator(r["form"], blocks, r["M"]).diag().abs()
    d = d >= 0.1 * d.max()
    u_j = runs["card_jacobi"]["u_p"]
    diff = float((r["u_p"] - u_j)[d].abs().max())
    lim = 1e-5 * max(float(u_j[d].abs().max()), 1.0)
    dom = r["form"].terms[0][0]
    field = (l2_norm(r["u_f"] - runs["card_jacobi"]["u_f"], dom)
             / l2_norm(runs["card_jacobi"]["u_f"], dom))
    phase("newton_small", n_bg=64,
          newton_iters={k: len(v["steps"]) for k, v in runs.items()},
          linear_iters={k: [s_["linear_iters"] for s_ in v["steps"]]
                        for k, v in runs.items()},
          residual={k: v["r"] / v["r0"] for k, v in runs.items()},
          max_abs_diff_mg_jacobi=diff, bound=lim,
          field_rel_diff_mg_jacobi=field)
    if len(r["steps"]) != len(runs["host_mg"]["steps"]):
        fail("newton n_bg=64: the card and the host take different numbers "
             "of Newton iterations")
    if not (r["u_p"].is_cuda and diff <= lim and field <= 1e-5):
        fail(f"newton n_bg=64: the mg and jacobi iterates differ by {diff} "
             f"(field: {field})")

    # -- the line-search case ---------------------------------------------------
    # n_bg = 16 (the reference test's size) with host direct solves: the
    # far-field Jacobian is near-singular (atan' ≈ 1/325, no boundary
    # term), which an f32 MG-CG pass cannot resolve
    plain = newton_run(16, dev, kind="atan", start=20.0, max_iters=3,
                       linear_method="direct")
    ls = newton_run(16, dev, kind="atan", start=20.0, max_iters=20,
                    line_search=True, linear_method="direct")
    phase("newton_line_search", n_bg=16,
          plain_newton="raised" if plain["error"] else "converged",
          plain_residuals=[s_["residual_norm"] for s_ in plain["steps"]],
          line_search_residuals=[s_["residual_norm"] for s_ in ls["steps"]],
          line_search="raised" if ls["error"] else "converged",
          line_search_steps=len(ls["steps"]),
          residual=None if ls["error"] else ls["r"])
    stuck = (plain["steps"][-1]["residual_norm"]
             >= 0.9 * plain["steps"][0]["residual_norm"])
    if not (plain["error"] and stuck and ls["error"] is None
            and ls["r"] < 1e-6):
        fail("newton: the atan case needs plain Newton to make no progress "
             "in 3 steps and the line search to converge")
    del plain, ls, runs, r

    # -- solve_newtons_linear with pinned dofs ---------------------------------
    mesh, M = immersed_square_problem(n_fg=fg_of(64), n_bg=64, device=dev)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=dev)
    u_f0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=dev)
    A, b = assemble_background_system(prob.form, u_f0, M)
    diag = A.diag()
    pin = torch.argsort(diag)[-2:].cpu().numpy()
    warm = torch.ones(M.n_bg_dofs, dtype=torch.float64, device=dev)
    (u, u_f), dt = sync_time(lambda: newton.solve_newtons_linear(
        prob.form, u_f0, M, warm, zero_ids=pin, monitor_newton=False,
        linear_method="cg", linear_pc="jacobi"))
    mask = trim.mask_from_ids(pin, M.n_bg_dofs, device=dev)
    A_t, b_t = A.with_trim(mask), trim.apply_trim_rhs(b, mask)
    u_d, _ = ksp.solve_ksp(A_t, b_t, method="direct")
    relres = rel_residual(A_t, b_t, u)
    norms, norms_d = prob.error_norms(u_f), prob.error_norms(M.mv(u_d))
    rel = {k: abs(norms[k] - norms_d[k]) / norms_d[k] for k in norms}
    phase("newtons_linear", n_bg=64, pinned=pin.tolist(), seconds=dt,
          pinned_values=u[mask].tolist(), rel_residual=relres,
          error_norms=norms, error_norms_direct=norms_d, norms_rel_diff=rel)
    if not (u.is_cuda and bool((u[mask] == 0).all()) and relres < 1e-6
            and max(rel.values()) < 1e-5):
        fail(f"solve_newtons_linear: pinned {u[mask].tolist()}, residual "
             f"{relres}, norms differ from the direct solve's by {rel}")
    del mesh, M, prob, A, b

    # -- the main run at n_bg = N_BG_NEWTON ------------------------------------
    torch.cuda.empty_cache()
    names = ("stencil_mv", "jacobi_smooth", "stencil_mv_block", "smooth")
    r, seconds, launches, by_shape = counted_run(
        lambda: newton_run(N_BG_NEWTON, dev,
                           lattice_shape=(N_BG_NEWTON + 1,) * 2, **mg),
        names, "newton")
    if r["error"]:
        fail(f"newton n_bg={N_BG_NEWTON}: {r['error']}")
    phase("newton", n_bg=N_BG_NEWTON, n_bg_dofs=r["M"].n_bg_dofs,
          n_block_cells=r["form"].terms[0][0].n_elem, seconds=seconds,
          newton_iters=len(r["steps"]),
          linear_iters=sum(s_["linear_iters"] for s_ in r["steps"]),
          steps=r["steps"], residual_first=r["r0"], residual_final=r["r"],
          launches=launches, launches_by_shape=by_shape,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not (r["u_p"].is_cuda and bool(torch.isfinite(r["u_p"]).all())):
        fail("newton: the iterate is not a finite card vector")
    if not r["r"] <= 1e-8 * r["r0"]:
        fail(f"newton: projected residual {r['r']} > 1e-8 x {r['r0']}")
    # a converged step's rhs is below the linear solve's atol: no iteration
    iterated = [s_ for s_ in r["steps"] if s_["linear_iters"]]
    if not (iterated and all(s_["launches"] > 0 for s_ in iterated)):
        fail(f"newton: a step's linear solve iterated without a stencil "
             f"launch: {r['steps']}")


N_BG_ASM = 256


def phase_asm():
    """``solve_ksp(gmres, pc='asm')`` on immersed Poisson at n_bg = N_BG_ASM
    (n_fg = 2·n_bg, the fg/bg ratio of the reference's asm test; 66,049
    dofs: the patch setup is host loops over dofs, a demo-size
    preconditioner) against pc='jacobi', both to rtol 1e-12: the residual
    (≤ 1.5e-10), fewer iterations, the same solution to 1e-7·max|u| on
    dofs with a nonzero diagonal (at rtol 1e-10 the two solutions are
    2.3e-7 apart at this size, on well-supported dofs: the system's
    conditioning times the residual)."""
    import torch

    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers import ksp, precond

    dev = torch.device("cuda", 0)
    mesh, M = immersed_square_problem(n_fg=2 * N_BG_ASM, n_bg=N_BG_ASM,
                                      device=dev)
    prob = PoissonProblem(mesh, k=1, sym=True, beta_value=10, device=dev)
    A, b = assemble_background_system(
        prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                               device=dev), M)
    made, out = [], {}
    schwarz = precond.AdditiveSchwarz

    def recorded(*a, **kw):
        made.append(sync_time(lambda: schwarz(*a, **kw)))
        return made[-1][0]

    precond.AdditiveSchwarz = recorded
    try:
        for pc in ("asm", "jacobi"):
            (x, info), dt = sync_time(lambda: ksp.solve_ksp(
                A, b, method="gmres", pc=pc, rtol=1e-12, atol=1e-14,
                monitor=False))
            out[pc] = (x, info, dt)
    finally:
        precond.AdditiveSchwarz = schwarz
    x_a, info_a, t_a = out["asm"]
    x_j, info_j, t_j = out["jacobi"]
    relres = rel_residual(A, b, x_a)
    d = A.diag().abs() > 0
    diff = float((x_a - x_j)[d].abs().max())
    lim = 1e-7 * max(float(x_j.abs().max()), 1.0)
    asm, t_setup = made[0]
    phase("asm", n_bg=N_BG_ASM, n_bg_dofs=M.n_bg_dofs,
          patches=asm.n_patches, width=asm.width, setup_seconds=t_setup,
          solve_seconds=t_a - t_setup, iters=info_a.iters,
          rel_residual=relres, jacobi_iters=info_j.iters,
          jacobi_seconds=t_j, max_abs_diff=diff, bound=lim,
          tables_on_card=bool(asm.inv.is_cuda and asm.idx.is_cuda))
    if not (x_a.is_cuda and asm.inv.is_cuda and relres <= 1.5e-10):
        fail(f"asm: residual {relres}, or a tensor off the card")
    if not info_a.iters < info_j.iters:
        fail(f"asm: {info_a.iters} iterations, jacobi {info_j.iters}")
    if not diff <= lim:
        fail(f"asm: differs from the jacobi solution by {diff} > {lim}")


# -- the biharmonic (radius-3 stencils, f64 and f32 routes) ---------------------

MAX_GMRES_ITERS_BH = 100         # the host's f64 cycle: 16 / 20 / 24 at
                                 # n_bg = 63 / 127 / 255; catches a cycle
                                 # that stops contracting
VS_LU_BOUND_BH = 1e-8            # n_bg=127 vs host SuperLU, L2 over the
                                 # cell domain (host f64 route 6.9e-10)
OTHER_ROUTE_MAX_IT = 600         # the route not taken: an iteration cap
# card and host demo runs (both f64, the same 16 iterations at n_bg=63)
# agree on the error norms to ~1e-7: an L2_rel of 9.4e-6 turns a solution
# difference of 1e-12 (what a 1e-10 residual leaves at κ ~ h⁻⁴) into 1e-7 of
# the norm; host LU and MG-GMRES differ by 2.6e-5 there
DEMO_NORMS_BH = 1e-6


def build_biharmonic(n_bg: int, device, bg_degree: int = 2):
    """bench.py's biharmonic workload at ``n_bg``: the immersed square on
    nested grids (n_fg = 2·n_bg, P2) over the quadratic B-spline net
    (n_bg + 2)² (``bg_degree`` 3: the cubic net (n_bg + 3)²),
    BiharmonicProblem(sym=False, β = α = 5, filter 1e-5),
    assembled by the front-end at u = 0. Returns (prob, M, lattice shape,
    A, b, seconds per stage: the foreground mesh, its P2 numbering, the
    B-spline extraction, the problem, the assembly)."""
    import torch

    from iifea_tpu_torch.mesh import bspline, generators
    from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system

    host = Counter()
    t0 = time.perf_counter()
    with timed_calls([(generators, "FunctionSpace"),
                      (bspline.BSplineSpace2D, "transfer_matrix")], host):
        mesh, M, shape = generators.immersed_square_bspline_problem(
            n_fg=2 * n_bg, n_bg=n_bg, bg_degree=bg_degree, device=device)
    t1 = time.perf_counter()
    prob = BiharmonicProblem(mesh, sym=False, beta_value=5.0,
                             alpha_value=5.0, filter_tol=1e-5, device=device)
    t2 = time.perf_counter()
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    (A, b), t_asm = sync_time(
        lambda: assemble_background_system(prob.form, u0, M))
    p2, ext = host["FunctionSpace"], host["transfer_matrix"]
    return prob, M, tuple(shape), A, b, {
        "mesh": t1 - t0 - p2 - ext, "p2_numbering": p2,
        "bspline_extraction": ext, "BiharmonicProblem": t2 - t1,
        "assemble": t_asm}


def bh_solve(A, b, shape, radius: int = 3, **kw):
    """bench.py's biharmonic solve: MG-GMRES on the radius-3 stencil (the
    cubic net's: ``radius`` 4) to a 1e-10 relative residual (``kw``
    overrides, e.g. ``mixed``)."""
    from iifea_tpu_torch.solvers import ksp

    kw = {"method": "gmres", "pc": "mg", "rtol": 1e-10, **kw}
    if kw["pc"] == "mg":
        kw.update(lattice_shape=shape, stencil_radius=radius)
    return ksp.solve_ksp(A, b, monitor=False, **kw)


def vs_lu(prob, M, u, u_lu) -> float:
    """bench.py's ``vs_lu_rel_diff``: the two solutions' difference in L2
    over the physical cell domain, relative to the LU solution's norm."""
    from iifea_tpu_torch.api import l2_norm

    u_lu_f = M.mv(u_lu)
    return (l2_norm(M.mv(u) - u_lu_f, prob.cell_dom)
            / max(l2_norm(u_lu_f, prob.cell_dom), 1e-300))


def default_route_bh() -> str:
    """The route ``solve_ksp`` takes for an f64 radius-3 system on CUDA."""
    from iifea_tpu_torch.solvers import ksp

    return "mixed" if 3 <= ksp.MIXED_DEFAULT_MAX_RADIUS else "f64"


def phase_small_reference_biharmonic():
    """The biharmonic against host references: at ncp 17 and 65 (n_bg =
    15, 63) the card's MG-GMRES and host SuperLU on the same assembled
    system give L2_rel within 2e-2 of each other (the JAX test's
    yardstick); at n_bg = 63 the card's iteration count is within 2 of the
    port's host f64 run; at n_bg = 127 the solutions agree with LU within
    VS_LU_BOUND_BH in L2 over the cell domain (bench.py's
    ``vs_lu_rel_diff``)."""
    import torch

    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    for n_bg in (15, 63, 127):
        prob, M, shape, A, b, _ = build_biharmonic(n_bg, gpu)
        u_lu, _ = bh_solve(A, b, shape, method="direct")
        n_lu = prob.error_norms(M.mv(u_lu))
        (u, info), dt = sync_time(lambda: bh_solve(A, b, shape))
        norms = prob.error_norms(M.mv(u))
        row = {"n_bg": n_bg, "ncp": list(shape), "route": default_route_bh(),
               "iters": info.iters, "rel_residual": rel_residual(A, b, u),
               "seconds": dt, "error_norms": norms, "error_norms_lu": n_lu,
               "l2_rel_diff": abs(norms["L2_rel"] - n_lu["L2_rel"])
               / n_lu["L2_rel"], "vs_lu_rel_diff": vs_lu(prob, M, u, u_lu)}
        if n_bg == 63:
            p_h, M_h, _, A_h, b_h, _ = build_biharmonic(n_bg, cpu)
            u_h, info_h = bh_solve(A_h, b_h, shape)
            row.update(host_iters=info_h.iters,
                       host_error_norms=p_h.error_norms(M_h.mv(u_h)))
        phase("small_reference_biharmonic", **row)
        if not (u.is_cuda and row["rel_residual"] < 1e-10):
            fail(f"biharmonic n_bg={n_bg}: residual {row['rel_residual']}")
        if not row["l2_rel_diff"] <= 2e-2:
            fail(f"biharmonic n_bg={n_bg}: L2_rel {norms['L2_rel']} against "
                 f"host LU's {n_lu['L2_rel']}")
        if n_bg == 63 and not abs(info.iters - row["host_iters"]) <= 2:
            fail(f"biharmonic n_bg=63: {info.iters} iterations on the card, "
                 f"{row['host_iters']} on the host")
        if n_bg == 127 and not row["vs_lu_rel_diff"] <= VS_LU_BOUND_BH:
            fail(f"biharmonic n_bg=127: vs_lu_rel_diff "
                 f"{row['vs_lu_rel_diff']} > {VS_LU_BOUND_BH}")


def phase_biharmonic():
    """bench.py --workload biharmonic at n_bg = 511 (513² = 263,169
    background dofs, 2,089,968 P2 triangles): host set-up and assembly per
    stage, ``solve_ksp(gmres, pc='mg', stencil_radius=3)`` once counted per
    kernel and lattice shape (no plain stencil apply on the card outside
    the coarse dense inverse), three warm solves staged (probe, hierarchy,
    Krylov), a profiled one, peak memory; f64 residual < 1e-10 and error
    norms below n_bg = 127's. Then the route not taken (f32 mixed or f64),
    counted, with its iterations, passes and residual, converged or not.
    Returns {instance tag: (launches by kernel, launches by shape)}."""
    import torch

    from iifea_tpu_torch.api import l2_norm
    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.solvers import ksp

    gpu = torch.device("cuda", 0)
    p127, M127, s127, A127, b127, _ = build_biharmonic(127, gpu)
    n127 = p127.error_norms(M127.mv(bh_solve(A127, b127, s127)[0]))
    del p127, M127, A127, b127
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, shape, A, b, setup = build_biharmonic(N_BG_BH, gpu)
    phase("biharmonic_setup", n_bg=N_BG_BH, n_fg=2 * N_BG_BH,
          lattice=list(shape), n_bg_dofs=M.n_bg_dofs,
          n_fg_nodes=prob.space.n_nodes, n_cells=prob.mesh.n_cells,
          n_block_cells=prob.cell_dom.n_elem, n_facets=prob.facet_dom.n_elem,
          eliminated=prob.elim_counts, seconds=setup,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    route = default_route_bh()
    names = ("stencil_mv", "jacobi_smooth", "stencil_mv_block", "smooth")
    plain = Counter()
    torch.cuda.reset_peak_memory_stats()
    with plain_on_card(plain):
        (u, info), t_first, launches, by_shape = counted_run(
            lambda: bh_solve(A, b, shape), names, "biharmonic")
    peak = torch.cuda.max_memory_allocated() / 2**30
    relres = rel_residual(A, b, u)
    norms = prob.error_norms(M.mv(u))
    tag = instance_tag(3, route == "f64")
    phase("biharmonic", route=route, first_seconds=t_first,
          iters=info.iters,
          passes=len(info.history) - 1 if route == "mixed" else 1,
          rel_residual=relres, error_norms=norms, error_norms_n_bg127=n127,
          launches=launches, launches_by_shape=by_shape,
          plain_applies_on_card=dict(plain), peak_gib=peak)
    if not relres < 1e-10:
        fail(f"biharmonic: f64 relative residual {relres} >= 1e-10")
    if not info.iters <= MAX_GMRES_ITERS_BH:
        fail(f"biharmonic: {info.iters} GMRES iterations > "
             f"{MAX_GMRES_ITERS_BH}")
    if not (u.shape == (M.n_bg_dofs,) and u.is_cuda
            and bool(torch.isfinite(u).all())):
        fail("biharmonic: the solution is not a finite card vector of the "
             "background size")
    missing = [s_ for s_ in LEVELS_BH if not any(
        by_shape.get(f"{k}@{s_[0]}x{s_[1]}{tag}", 0) > 0 for k in names)]
    if missing:
        fail(f"biharmonic: no stencil launch at the smoothed shapes "
             f"{missing}: {by_shape}")
    if plain["elsewhere"]:
        fail(f"biharmonic: {plain['elsewhere']} plain stencil applies on the "
             "card outside the coarse dense inverse")
    if not all(norms[k] < n127[k] for k in ("L2_rel", "H2_rel")):
        fail(f"biharmonic: error norms {norms} not below n_bg=127's {n127}")

    # three warm solves, staged: probe, hierarchy, Krylov (the rest)
    runs = []
    for _ in range(3):
        stages = Counter()
        with timed_calls([(ksp, "_probe_general"),
                          (multigrid, "StencilMultigrid")], stages):
            (_, info_w), t_w = sync_time(lambda: bh_solve(A, b, shape))
        runs.append({"solve_ksp": t_w, "probe": stages["_probe_general"],
                     "hierarchy": stages["StencilMultigrid"],
                     "krylov": t_w - sum(stages.values()),
                     "iters": info_w.iters})
    runs.sort(key=lambda r: r["solve_ksp"])
    phase("biharmonic_stages", setup=setup, median=runs[1], runs=runs)
    profile_solve(lambda: bh_solve(A, b, shape), "biharmonic_profile")

    # the route not taken, counted, capped
    other = "mixed" if route == "f64" else "f64"
    (u_o, info_o), t_o, launches_o, by_shape_o = counted_run(
        lambda: bh_solve(A, b, shape, mixed=other == "mixed",
                         max_it=OTHER_ROUTE_MAX_IT), names,
        "biharmonic_other_route")
    relres_o = rel_residual(A, b, u_o)
    u_f = M.mv(u)
    phase("biharmonic_other_route", route=other, seconds=t_o,
          iters=info_o.iters,
          passes=len(info_o.history) - 1 if other == "mixed" else 1,
          history=info_o.history if other == "mixed" else None,
          rel_residual=relres_o, converged=relres_o < 1e-10,
          error_norms=prob.error_norms(M.mv(u_o)),
          l2_diff_from_route=l2_norm(M.mv(u_o) - u_f, prob.cell_dom)
          / l2_norm(u_f, prob.cell_dom),
          launches=launches_o, launches_by_shape=by_shape_o)
    return {tag: (launches, by_shape),
            instance_tag(3, other == "f64"): (launches_o, by_shape_o)}


def phase_demo_biharmonic():
    """The biharmonic demo on the card (the ``main`` of ``python3 -m
    iifea_tpu_torch.demos.biharmonic --ref 2``, in this process: n_bg = 63,
    MG-GMRES on the radius-3 kernels), held against the same demo on the
    host: the same iteration count, relative L2/H1/H2 errors equal to
    DEMO_NORMS_BH relative."""
    biharmonic_demo(["--ref", "2"], "demo_biharmonic")


def biharmonic_demo(argv, tag):
    """``iifea_tpu_torch.demos.biharmonic``'s ``main(argv)`` (what ``python3
    -m iifea_tpu_torch.demos.biharmonic`` runs) in this process on the card
    against the same demo on the host."""
    import io

    from iifea_tpu_torch.demos import biharmonic as demo

    out, wall, launched, peak = demo_in_process(demo, argv, "cuda")
    norms = {k: out["norms"][k] for k in ("L2_rel", "H1_rel", "H2_rel")}
    with contextlib.redirect_stdout(io.StringIO()):
        host = demo.main(argv + ["--device", "cpu"])
    rel = {k: abs(v - host["norms"][k]) / host["norms"][k]
           for k, v in norms.items()}
    phase(tag, argv=argv, seconds=wall, iters=out["info"].iters,
          error_norms=norms, host_iters=host["info"].iters,
          host_error_norms={k: host["norms"][k] for k in norms},
          norms_rel_diff=rel, launches=launched, peak_gib=peak)
    if not (out["u_p"].is_cuda and out["info"].iters == host["info"].iters
            and max(rel.values()) <= DEMO_NORMS_BH):
        fail(f"{tag}: card norms {norms} (iterations "
             f"{out['info'].iters}) differ from the host's "
             f"{host['norms']} ({host['info'].iters})")


# -- the 3D biharmonic (radius-3 3D stencils, f64 and f32 routes) ----------------

N_BG_BH3 = 63                    # demos/biharmonic.py --dim 3 --ref 3
# its V-cycle smooths 65³, 33³ and 17³ (9³ is dense)
LEVELS_BH3 = [(s_,) * 3 for s_ in (65, 33, 17)]
ODD_SHAPES3 = [(9, 11, 13), (13, 10, 17)]
SOAK3_R3_ROUNDS = 67             # x 3 kernels x 2 dtypes = 402 launches
# the 3D scalar paths' kernels: the Krylov apply, and per smoothed level
# either one smooth3 launch a smoothing call or, one launch a pass, the
# step from zero (zero3), the Chebyshev steps (cheb_step3) and the residual
# (residual3)
PASSES3 = ("zero3", "cheb_step3", "residual3")
NAMES3 = ("stencil_mv3", *PASSES3, "smooth3")


def names3(shapes, radius: int, f64: bool) -> tuple:
    """The kernels a scalar 3D cycle on these smoothed level shapes
    launches: NAMES3, less smooth3 where the plan holds no level in one
    launch and less the per-pass kernels where it holds every level."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    fused = [bool(sk._plan3(tuple(sh), radius, 1,
                            torch.cuda.current_device(), f64)[1])
             for sh in shapes]
    return tuple(k for k in NAMES3
                 if not (k == "smooth3" and not any(fused))
                 and not (k in PASSES3 and all(fused)))
# The JAX package's rows of demos/biharmonic.py --mesh-root synthetic --dim 3
# --ref 0..3 (f64 gmres+mg on a CPU; studies/biharmonic_synthetic.jsonl, the
# nested-grid rows, whose "L2", "H1", "H2" columns hold the demo's relative
# norms): n_bg -> (L2_rel, H1_rel, H2_rel)
JAX_ROWS_BH3 = {
    7: (0.1428220610425672, 0.12418013668221375, 0.2746447425956136),
    15: (0.02017422759514977, 0.023812133154838353, 0.15326933943776525),
    31: (0.005758727846594967, 0.006268661317644784, 0.08687087530315084),
    63: (0.0033229229058757723, 0.0022137878170189924, 0.05196277158289589),
}
JAX_ROW_REL = 1e-5               # the card's norms against those rows
# ... at n_bg = 63, where a 1e-10 residual leaves the norms uncertain by
# ~1e-5 (κ ~ h⁻⁴): on an H100 the converged solution (rtol 1e-12, which
# an earlier form of this phase solved; PERF.md §5) lay 1.1–1.3e-5 from
# the JAX row (that row's own 1e-10 solve), the 1e-10 one 1.5–2.4e-5; two
# 1e-10 solves may differ by the sum of their distances from the converged
# one, and the bound leaves twice that
JAX_ROW_REL_63 = 5e-5
# the host's f64 cycle takes 12 / 684 / 432 iterations at n_bg = 7 / 15 /
# 31 (GMRES(300)); the bound catches a cycle that stops contracting
MAX_GMRES_ITERS_BH3 = 3000
PEAK_GIB = 80.0                  # the card's memory


def kernels3_r3(worst, dev):
    """The 3D biharmonic's instances: stencil_mv3, jacobi_smooth3 and
    cheb_step3 (β = 0 and β ≠ 0) at radius 3 in f32 and f64 against their
    plain versions (TOL, TOL64) at odd shapes and at every level of the
    65³ hierarchy, one launch a call; a soak of SOAK3_R3_ROUNDS rounds of
    the three at 65³ in both types, bitwise against each first result;
    each instance's registers and spill from the compiler's report (no
    spill allowed); device, call and bound times at 65³, 33³ and 17³
    (the plain versions' at 65³). Returns the ``kernel_time`` rows."""
    import numpy as np
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    rng = np.random.default_rng(3)

    def operands(shape, dt):
        n = shape[0] * shape[1] * shape[2]

        def t(a):
            return torch.tensor(a, dtype=dt, device=dev)

        return (t(rng.standard_normal((343, *shape))),
                t(rng.standard_normal(n)), t(rng.standard_normal(n)),
                t(rng.uniform(0.5, 2.0, n)), t(rng.standard_normal(n)))

    for dt in (torch.float32, torch.float64):
        for shape in ODD_SHAPES3 + LEVELS_BH3:
            C, x, b, invd, d = operands(shape, dt)
            before = sk.launches()
            y = sk.stencil_mv3(C, x, shape, 3)
            j = sk.jacobi_smooth3(C, invd, b, x, 0.67, shape, 3)
            c0, d0 = sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, shape, 3)
            c1, d1 = sk.cheb_step3(C, invd, b, x, d.clone(), 1.3, 0.45,
                                   shape, 3)
            after = sk.launches()
            made = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            if made != {"stencil_mv3": 1, "jacobi_smooth3": 1,
                        "cheb_step3": 2}:
                fail(f"radius-3 3D calls at {shape} made launches {made}")
            _check(worst, "stencil_mv3", y,
                   sk.stencil_mv3_plain(C, x, shape, 3), shape, 3,
                   quiet=True)
            _check(worst, "jacobi_smooth3", j,
                   sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, shape, 3),
                   shape, 3, quiet=True)
            for (cx, cd), d_in, alpha, beta in (((c0, d0), None, 1.7, 0.0),
                                                ((c1, d1), d, 1.3, 0.45)):
                rx, rd = sk.cheb_step3_plain(C, invd, b, x, d_in, alpha,
                                             beta, shape, 3)
                _check(worst, "cheb_step3", cx, rx, shape, 3, quiet=True)
                _check(worst, "cheb_step3", cd, rd, shape, 3, quiet=True)
            del C, x, b, invd, d
    torch.cuda.empty_cache()

    # soak at 65³: interleaved, never synchronised until the end
    sh = LEVELS_BH3[0]
    soak = []
    for dt in (torch.float32, torch.float64):
        C, x, b, invd, _ = operands(sh, dt)
        soak.append(((C, x, b, invd),
                     (sk.stencil_mv3(C, x, sh, 3),
                      sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, 3),
                      sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, sh,
                                    3)[0])))
    mismatches = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for _ in range(SOAK3_R3_ROUNDS):
        for (C, x, b, invd), (y0, j0, c0) in soak:
            mismatches += (sk.stencil_mv3(C, x, sh, 3) != y0).sum()
            mismatches += (sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, 3)
                           != j0).sum()
            mismatches += (sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, sh,
                                         3)[0] != c0).sum()
    torch.cuda.synchronize()
    soak_s = time.perf_counter() - t0
    for (C, x, b, invd), (y0, j0, c0) in soak:
        _check(worst, "stencil_mv3", y0, sk.stencil_mv3_plain(C, x, sh, 3),
               sh, 3, quiet=True)
    phase("soak", launches=SOAK3_R3_ROUNDS * 6, shapes=[list(sh)], radius=3,
          dtypes=["f32", "f64"], seconds=soak_s, mismatches=int(mismatches))
    if int(mismatches) != 0:
        fail(f"radius-3 soak: {int(mismatches)} values differ between "
             "repeats")
    del soak
    torch.cuda.empty_cache()

    # every 3D kernel instance: the marching pass and level kernels (24
    # each: f32 and f64, r = 1-4, 1-3 fields), the pass kernel's per-field
    # staging (16: 2 and 3 fields), the runtime-radius marching pass and
    # level kernels (6 each: f32 and f64, 1-3 fields) and the zero kernel
    # (6 in each of the r = 1-3, the r = 4 and the runtime-radius sources:
    # 18)
    instances = built_instances(("march",))
    phase("kernel_check", kernel="3D instances",
          worst={k: v for k, v in worst.items()
                 if k.split("/")[0] in NAMES3 and "/r3" in k},
          ptxas=instances)
    if len(instances) != 94 or any(
            r["spill_stores"] or r["spill_loads"] for r in instances):
        fail(f"the 3D instances are not all built without spill: "
             f"{instances}")

    rows = []
    for dt in (torch.float32, torch.float64):
        f64 = dt == torch.float64
        for sh in LEVELS_BH3:
            C, x, b, invd, d = operands(sh, dt)
            main = sh == LEVELS_BH3[0]

            def mv(C=C, x=x, sh=sh, f=sk.stencil_mv3):
                return f(C, x, sh, 3)

            def jac(C=C, x=x, b=b, invd=invd, sh=sh, f=sk.jacobi_smooth3):
                return f(C, invd, b, x, 0.67, sh, 3)

            def cheb(C=C, x=x, b=b, invd=invd, d=d, sh=sh,
                     f=sk.cheb_step3):
                return f(C, invd, b, x, d, 1.3, 0.45, sh, 3)

            for name, fn, plain in (
                    ("stencil_mv3", mv, sk.stencil_mv3_plain),
                    ("jacobi_smooth3", jac, sk.jacobi_smooth3_plain),
                    ("cheb_step3", cheb, sk.cheb_step3_plain)):
                rows.append(time_kernel(
                    name, sh, fn, partial(fn, f=plain) if main else None,
                    radius=3, f64=f64,
                    library=(csr_call(C, sh, 3, x)
                             if main and name == "stencil_mv3" else None)))
            del C, x, b, invd, d
    torch.cuda.empty_cache()
    return rows


# the cubic 3D paths: the biharmonic's 33³ → 17³ smoothed (9³ dense), the
# three-field elasticity's 17³ smoothed (3 × 9³ dense)
LEVELS_CUBIC3 = [(s_,) * 3 for s_ in (33, 17)]
LEVELS_CUBIC_EL3 = [(s_,) * 3 for s_ in (17, 9)]
SHAPE_EL3_WIDE_THIRD = (19, 19, 19)   # the 73³ cubic elasticity's third level


def kernels3_r4(worst, dev):
    """The radius-4 (729-tap) 3D instances, f32 and f64: stencil_mv3,
    jacobi_smooth3 and cheb_step3 (β = 0 and β ≠ 0) against their plain
    versions at odd shapes and at the cubic 33³ cycle's levels, one launch
    a call; stencil3d_block's four passes on scalar planes and 1–3 fields
    at an odd shape, and for three fields in f64 at the 3D elasticity's
    17³ and 9³; smooth3 by both routes at the cubic paths' smoothed levels
    (``kernels3_smooth``; their compiler reports held by ``kernels3_r3``).
    Then device, call and bound times, with the plain versions', of each
    kernel the cubic 3D paths launch. Returns the ``kernel_time`` rows."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(15)
    f32, f64 = torch.float32, torch.float64
    for dt in (f32, f64):
        for sh in ODD_SHAPES3 + LEVELS_CUBIC3:
            C, invd, b, x = scalar3_operands(gen, sh, 4, dt, dev)
            d = torch.randn(b.shape, generator=gen, device=dev, dtype=dt)
            before = sk.launches()
            y = sk.stencil_mv3(C, x, sh, 4)
            j = sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, 4)
            c0, d0 = sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, sh, 4)
            c1, d1 = sk.cheb_step3(C, invd, b, x, d.clone(), 1.3, 0.45, sh, 4)
            after = sk.launches()
            made = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            if made != {"stencil_mv3": 1, "jacobi_smooth3": 1,
                        "cheb_step3": 2}:
                fail(f"radius-4 3D calls at {sh} made launches {made}")
            _check(worst, "stencil_mv3", y, sk.stencil_mv3_plain(C, x, sh, 4),
                   sh, 4, quiet=True)
            _check(worst, "jacobi_smooth3", j,
                   sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, sh, 4), sh, 4,
                   quiet=True)
            for (cx, cd), d_in, alpha, beta in (((c0, d0), None, 1.7, 0.0),
                                                ((c1, d1), d, 1.3, 0.45)):
                rx, rd = sk.cheb_step3_plain(C, invd, b, x, d_in, alpha,
                                             beta, sh, 4)
                _check(worst, "cheb_step3", cx, rx, sh, 4, quiet=True)
                _check(worst, "cheb_step3", cd, rd, sh, 4, quiet=True)
            del C, invd, b, x, d
        for n_fields in (0, 1, 2, 3):
            check_block3(worst, gen, ODD_SHAPES3[1], 4, n_fields, dev, dt)
    for sh in LEVELS_CUBIC_EL3:
        check_block3(worst, gen, sh, 4, N_FIELDS_EL3, dev, f64)
    torch.cuda.empty_cache()
    rows = kernels3_smooth(worst, dev, [
        ("cubic3_f64", 0, 4, f64, True, LEVELS_CUBIC3, "fused"),
        ("cubic3_f32", 0, 4, f32, True, LEVELS_CUBIC3, "fused"),
        ("cubic_el3_f64", N_FIELDS_EL3, 4, f64, False, LEVELS_CUBIC_EL3[:1],
         "fused")])
    phase("kernel_check", kernel="radius 4 3D instances",
          worst={k: v for k, v in worst.items()
                 if "/r4" in k and "3" in k.split("/")[0]})

    for dt in (f32, f64):
        is64 = dt == f64
        for sh in LEVELS_CUBIC3:
            C, invd, b, x = scalar3_operands(gen, sh, 4, dt, dev)
            d = torch.randn(b.shape, generator=gen, device=dev, dtype=dt)
            main = sh == LEVELS_CUBIC3[0]
            rows.append(time_kernel(
                "stencil_mv3", sh, partial(sk.stencil_mv3, C, x, sh, 4),
                partial(sk.stencil_mv3_plain, C, x, sh, 4) if main else None,
                plain_launches=2, radius=4, f64=is64,
                library=csr_call(C, sh, 4, x) if main else None))
            rows.append(time_kernel(
                "cheb_step3", sh,
                partial(sk.cheb_step3, C, invd, b, x, d, 1.3, 0.45, sh, 4),
                partial(sk.cheb_step3_plain, C, invd, b, x, d, 1.3, 0.45, sh,
                        4) if main else None,
                plain_launches=2, radius=4, f64=is64))
            del C, invd, b, x, d
    # the cubic elasticity's 17³ level and the 73³ path's third, 19³
    for sh in (LEVELS_CUBIC_EL3[0], SHAPE_EL3_WIDE_THIRD):
        C, binv, b, x = block3_operands(gen, sh, 4, N_FIELDS_EL3, dev, f64)
        calls = block3_calls(C, binv, b, x, sh, 4, omega=1.0)
        plain = block3_calls(C, binv, b, x, sh, 4, omega=1.0, plain=True)
        held = []
        main = sh == LEVELS_CUBIC_EL3[0]
        for mode in BLOCK3_MODES:
            rows.append(time_kernel(
                sk.PASS3_NAMES[mode, True], [N_FIELDS_EL3, *sh], calls[mode],
                plain[mode] if main else None,
                bound_=bound_passes(sh, N_FIELDS_EL3, [mode], 4, True),
                plain_launches=2, radius=4, f64=True, n_fields=N_FIELDS_EL3,
                dim=3, library=block3_library(C, b, x, sh, 4, mode, held)))
            if not main and mode in ("apply", "sweep"):
                # (the summary's row is the main shape's)
                phase("plain_time", kernel=sk.PASS3_NAMES[mode, True],
                      shape=[N_FIELDS_EL3, *sh], radius=4, dtype="f64",
                      plain_ms=device_ms(plain[mode], launches=2, reps=3))
        del C, binv, b, x, calls, plain, held
        torch.cuda.empty_cache()
    return rows


# the 3D marching passes by staging (``check_rn3``): radius, shapes. A
# (5, 6, 700) lattice's x planes no block can stage at r >= 4 in f64 (nor
# at r = 5 in f32): only the unstaged route takes it
SHAPE_LONG_K = (5, 6, 700)
RN3_CHECKS = ((2, [ODD_SHAPES3[1]]), (3, [ODD_SHAPES3[1]]),
              (4, [ODD_SHAPES3[1], LEVELS_CUBIC_EL3[0], SHAPE_LONG_K]),
              (5, ODD_SHAPES3 + LEVELS_QUARTIC3 + [SHAPE_LONG_K]),
              (6, [ODD_SHAPES3[1], SHAPE_LONG_K]),
              (7, [ODD_SHAPES3[1], SHAPE_LONG_K]))


def check_rn3(worst, gen, shape, radius, n_fields, dev, dtype):
    """The 3D marching passes at ``shape`` on an nF-field operator (0:
    scalar planes) with zeros in the taps outside the lattice: apply,
    residual, sweep, sweep from zero and (scalar) the Chebyshev step, by
    the plan's staging and by the unstaged route of the runtime-radius
    kernel (at r = 1-4 also by the fixed-radius kernel's other staging
    where a block holds it; from r = 5 the unstaged route is the plan's),
    at the plan's split, each against its plain version (TOL, TOL64); at
    r = 1-4 the staged ones (the fixed-radius kernels) bitwise equal.
    Every route, and at r = 1-4 a
    level's smoothing call in one launch (two steps from zero with the
    residual, where the launch fits), again with NaN in those taps: no
    kernel reads them, so each output is bitwise the same. Returns (the
    plan, whether the stagings agreed bitwise, whether NaN in the padding
    taps left every output bitwise as it was)."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    C, binv, b, x = block3_operands(gen, shape, radius, n_fields, dev, dtype)
    nF, r = max(n_fields, 1), radius
    outside = sk.outside_taps(shape, r, dev)
    C[..., outside] = 0.0
    C_nan = C.clone()
    C_nan[..., outside] = float("nan")
    plan = sk._plan3(tuple(shape), r, nF, dev.index or 0,
                     dtype == torch.float64)
    # the runtime-radius kernel's routes: its staging (scalar planes) and
    # the unstaged one; at r = 1-4 the fixed-radius kernel's, and the
    # runtime-radius unstaged route
    staged = ([sk.ALL_FIELDS] + [sk.PER_FIELD] * (nF > 1)
              if plan[3] == sk.ALL_FIELDS and r <= 4 else [plan[3]])
    stagings = [st for st in staged if st != sk.UNSTAGED] + [sk.UNSTAGED]
    # the plain versions' arithmetic on one plain apply (that of
    # sweep3_block_plain and cheb_step3_plain after their b - A x)
    y_ref = sk.apply3_block_plain(C, x, shape, r)
    res_ref = b - y_ref

    def binv_of(v):
        if n_fields == 0:
            return binv * v
        return (binv * v.reshape(1, nF, -1)).sum(dim=1).reshape(-1)

    refs = {sk._APPLY: y_ref, sk._RESIDUAL: res_ref,
            sk._SWEEP: x + 0.8 * binv_of(res_ref),
            sk._ZERO: 0.8 * binv_of(b)}
    d = None
    if n_fields == 0:
        d = torch.randn(b.shape, generator=gen, device=dev, dtype=dtype)
        dn = 1.3 * binv * res_ref + 0.45 * d
        refs[sk._CHEB] = (x + dn, dn)
    bitwise = nan_equal = True
    for pass_, ref in refs.items():
        name = sk.PASS3_NAMES[sk._PASSES[pass_], nF > 1]
        got = []
        for st in stagings:
            def run(planes):
                dd = None if d is None else d.clone()
                y = sk._pass3(pass_, planes, None if pass_ == sk._ZERO else x,
                              b, binv, shape, r, nF, omega0=0.8,
                              s0=1.3 if pass_ == sk._CHEB else 0.8,
                              s1=0.45 if pass_ == sk._CHEB else 0.0, d=dd,
                              split=plan[0], staging=st)
                return (y, dd) if pass_ == sk._CHEB else (y,)

            outs = run(C)
            for v, v_ref in zip(outs, ref if pass_ == sk._CHEB else (ref,)):
                _check(worst, name, v, v_ref, shape, r, quiet=True,
                       n_fields=n_fields, staging=st)
            nan_equal &= all(torch.equal(a, c)
                             for a, c in zip(outs, run(C_nan)))
            got.append((st, outs))
        same = [o for st, o in got if st != sk.UNSTAGED]
        bitwise &= all(torch.equal(a, c) for o in same[1:]
                       for a, c in zip(same[0], o))
    if r <= 4:
        def level(planes):
            return sk._smooth3_cuda(sk.GRID, planes, binv, b, None,
                                    [(0.8, 0.0)] * NU, shape, r, nF, True,
                                    False, split=plan[0],
                                    staging=sk.ALL_FIELDS)
        try:
            outs = level(C)
        except RuntimeError:     # the level's blocks are not co-resident
            outs = None
        if outs is not None:
            nan_equal &= all(torch.equal(a, c)
                             for a, c in zip(outs, level(C_nan)))
    del C, C_nan, binv, b, x, d, refs
    return plan, bitwise, nan_equal


def kernels3_r5(worst, dev):
    """The 3D runtime-radius instances at r = 5 (1,331 taps), f32 and f64:
    stencil_mv3, jacobi_smooth3 and cheb_step3 (β = 0 and β ≠ 0) against
    their plain versions at odd shapes and at the quartic 33³ cycle's
    levels, one launch a call; stencil3d_block's four passes on scalar
    planes and 1–3 fields at an odd shape and, three fields in f64, at
    17³; every pass (``check_rn3``) at r = 5, 6, 7 (x read through the
    read-only cache), and the unstaged route at r = 2, 3, 4, 1–3 fields, at the
    ``RN3_CHECKS`` shapes, the long-k lattice only by the unstaged route,
    each route again with NaN in the taps outside the lattice, which must
    leave every output bitwise as it was (no kernel reads them);
    smooth3 at the quartic cycle's levels (``kernels3_smooth``: one launch
    a pass, and march_rn_level_kernel's one launch where the level's
    blocks are co-resident, bitwise equal to the passes, refused where
    they are not; it also times the cycle's step from zero and residual
    pass at 33³ and each route's calls). Then device, call, bound, plain
    and library times of the quartic 3D path's apply and Chebyshev step at
    33³, and of the three-field f64 r = 5 passes at 3 × 17³. Returns the
    ``kernel_time`` rows."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(16)
    f32, f64 = torch.float32, torch.float64
    for dt in (f32, f64):
        for sh in ODD_SHAPES3 + LEVELS_QUARTIC3:
            C, invd, b, x = scalar3_operands(gen, sh, 5, dt, dev)
            d = torch.randn(b.shape, generator=gen, device=dev, dtype=dt)
            before = sk.launches()
            y = sk.stencil_mv3(C, x, sh, 5)
            j = sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, 5)
            c0, d0 = sk.cheb_step3(C, invd, b, x, None, 1.7, 0.0, sh, 5)
            c1, d1 = sk.cheb_step3(C, invd, b, x, d.clone(), 1.3, 0.45, sh, 5)
            after = sk.launches()
            made = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            if made != {"stencil_mv3": 1, "jacobi_smooth3": 1,
                        "cheb_step3": 2}:
                fail(f"radius-5 3D calls at {sh} made launches {made}")
            _check(worst, "stencil_mv3", y, sk.stencil_mv3_plain(C, x, sh, 5),
                   sh, 5, quiet=True)
            _check(worst, "jacobi_smooth3", j,
                   sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, sh, 5), sh, 5,
                   quiet=True)
            for (cx, cd), d_in, alpha, beta in (((c0, d0), None, 1.7, 0.0),
                                                ((c1, d1), d, 1.3, 0.45)):
                rx, rd = sk.cheb_step3_plain(C, invd, b, x, d_in, alpha,
                                             beta, sh, 5)
                _check(worst, "cheb_step3", cx, rx, sh, 5, quiet=True)
                _check(worst, "cheb_step3", cd, rd, sh, 5, quiet=True)
            del C, invd, b, x, d
        for n_fields in (0, 1, 2, 3):
            check_block3(worst, gen, ODD_SHAPES3[1], 5, n_fields, dev, dt)
    check_block3(worst, gen, LEVELS_QUARTIC3[1], 5, N_FIELDS_EL3, dev, f64)
    torch.cuda.empty_cache()
    # the errors by staging, booked apart: at r = 2 and 4 the unstaged
    # route is not the plan's where a block stages; from r = 5 they join
    # their instances' worst errors
    plans, bitwise, nan_equal, seen = {}, True, True, {}
    for r, shapes in RN3_CHECKS:
        for dt in (f32, f64):
            for sh in shapes:
                for n_fields in (0, 2, 3):
                    plan, same, nan_same = check_rn3(seen, gen, sh, r,
                                                     n_fields, dev, dt)
                    bitwise &= same
                    nan_equal &= nan_same
                    plans[f"r{r} {'f64' if dt == f64 else 'f32'} nf"
                          f"{max(n_fields, 1)} {'x'.join(map(str, sh))}"] = \
                        list(plan)
                torch.cuda.empty_cache()
    long_k = [k for k in plans if k.endswith("x".join(map(str, SHAPE_LONG_K)))
              and (" f64 " in k and not k.startswith("r2")
                   or k.startswith("r5 f32"))]
    for k, v in seen.items():
        if re.search(r"/r[5-9]", k):
            worst[k] = max(worst.get(k, 0.0), v)
    phase("kernel_check", kernel="3D marching passes by staging",
          plans=plans, stagings_bitwise_equal=bitwise,
          padding_nan_bitwise_equal=nan_equal, worst=seen)
    if not bitwise:
        fail("the 3D marching passes differ between stagings")
    if not nan_equal:
        fail("a 3D marching route's output changed with NaN in the taps "
             "outside the lattice: the kernel read them")
    if any(plans[k][3] != sk.UNSTAGED for k in long_k):
        fail(f"a block stages the x planes of {SHAPE_LONG_K}: "
             f"{ {k: plans[k] for k in long_k} }")
    rows = kernels3_smooth(worst, dev, [
        ("quartic3_f64", 0, 5, f64, True, LEVELS_QUARTIC3, "fused"),
        ("quartic3_f32", 0, 5, f32, True, LEVELS_QUARTIC3, "fused")])
    phase("kernel_check", kernel="radius 5 3D instances",
          worst={k: v for k, v in worst.items()
                 if "/r5" in k and "3" in k.split("/")[0]})
    sh = LEVELS_QUARTIC3[0]
    for dt in (f32, f64):
        is64 = dt == f64
        C, invd, b, x = scalar3_operands(gen, sh, 5, dt, dev)
        d = torch.randn(b.shape, generator=gen, device=dev, dtype=dt)
        plan = sk._plan3(sh, 5, 1, dev.index or 0, is64)
        rows.append(time_kernel(
            "stencil_mv3", sh, partial(sk.stencil_mv3, C, x, sh, 5),
            partial(sk.stencil_mv3_plain, C, x, sh, 5), plain_launches=2,
            radius=5, f64=is64, library=csr_call(C, sh, 5, x),
            split=plan[0], staging=STAGINGS[plan[3]]))
        rows.append(time_kernel(
            "cheb_step3", sh,
            partial(sk.cheb_step3, C, invd, b, x, d, 1.3, 0.45, sh, 5),
            partial(sk.cheb_step3_plain, C, invd, b, x, d, 1.3, 0.45, sh, 5),
            plain_launches=2, radius=5, f64=is64))
        del C, invd, b, x, d
    torch.cuda.empty_cache()
    sh = LEVELS_QUARTIC3[1]
    C, binv, b, x = block3_operands(gen, sh, 5, N_FIELDS_EL3, dev, f64)
    calls = block3_calls(C, binv, b, x, sh, 5, omega=1.0)
    plain = block3_calls(C, binv, b, x, sh, 5, omega=1.0, plain=True)
    plan = sk._plan3(sh, 5, N_FIELDS_EL3, dev.index or 0, True)
    held = []
    for mode in BLOCK3_MODES:
        rows.append(time_kernel(
            sk.PASS3_NAMES[mode, True], [N_FIELDS_EL3, *sh], calls[mode],
            plain[mode], bound_=bound_passes(sh, N_FIELDS_EL3, [mode], 5,
                                             True),
            plain_launches=1, radius=5, f64=True, n_fields=N_FIELDS_EL3,
            dim=3, library=block3_library(C, b, x, sh, 5, mode, held),
            split=plan[0], staging=STAGINGS[plan[3]]))
    del C, binv, b, x, calls, plain, held
    torch.cuda.empty_cache()
    return rows


# the per-field staging (f64, r = 4, three fields): the shapes where a
# block holds every field's planes, at which both stagings must agree
# bitwise (the 3D elasticity's 65³, where the apply and the residual are
# also timed by both stagings and against the library call, and odd
# shapes, two levels the plan gives one launch); the 3D elasticity cell's
# width, 97³, where each per-field pass is held to its plain version; and
# the 73³ cubic net of the elasticity3_wide phase, where the passes are
# timed
STAGING_BOTH = [(65, 65, 65), (13, 10, 17), (17, 17, 17), (9, 9, 9)]
SHAPE_PF_CHECK = (97, 97, 97)
SHAPE_EL3_WIDE = (73, 73, 73)
# the tag of the per-field staging's summary rows and launches
PF_TAG = instance_tag(4, True, N_FIELDS_EL3) + "/pf"


def wide3_operands(gen, shape, dev):
    """``block3_operands``' three-field f64 r = 4 operator, b and x, with
    the inverse of each node's centre block as its smoother blocks (the
    multigrid's l1 blocks sum |C|, a copy of the planes: 48 GB at 97³)."""
    import torch

    nF, m3 = N_FIELDS_EL3, 9 ** 3
    C = torch.rand((nF, nF, m3, *shape), generator=gen, device=dev,
                   dtype=torch.float64).sub_(0.5).mul_(0.2)
    for f in range(nF):
        C[f, f, m3 // 2] += 4.0
    binv = torch.linalg.inv(C[:, :, m3 // 2].reshape(nF, nF, -1).permute(
        2, 0, 1)).permute(1, 2, 0).contiguous()
    n = nF * math.prod(shape)
    b, x = (torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
            for _ in range(2))
    return C, binv, b, x


def kernels3_staging(worst, dev):
    """The marching kernels' per-field staging, f64, r = 4, three fields:
    at the STAGING_BOTH shapes every pass of stencil3d_block (apply,
    residual, sweep, sweep from zero) at the plan's split with one field's
    x planes staged at a time equals the all-field staging bitwise, and so
    does a level's smoothing call (two sweeps from zero with the residual)
    by one launch a pass; the plan stages every field there, and a level's
    one launch, which stages every field, refuses the per-field staging. At
    3 × 65³ the apply and the residual by both stagings are timed with
    their library call (``block3_library``: the CSR form holds 1.6 G
    nonzeros there, within int32 indices), beside the per-field rows. At
    3 × 97³, where the plan stages one field at a time, each pass against
    its plain version (TOL64); at 3 × 73³ (the elasticity3_wide phase's
    finest level) device, call, bound and plain times of each pass (the
    summary's ``…/pf`` rows). Returns the ``kernel_time`` rows."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(17)
    f64, nF, idx = torch.float64, N_FIELDS_EL3, dev.index or 0
    bitwise, plans, grid_refused, rows = True, {}, True, []
    for sh in STAGING_BOTH:
        C, binv, b, x = block3_operands(gen, sh, 4, nF, dev, f64)
        plan = sk._plan3(sh, 4, nF, idx, True)
        plans["x".join(map(str, sh))] = list(plan)
        if plan[3] != sk.ALL_FIELDS:
            fail(f"the plan stages one field at a time at {sh}: {plan}")
        for pass_, start, bi in ((sk._APPLY, x, None),
                                 (sk._RESIDUAL, x, None),
                                 (sk._SWEEP, x, binv),
                                 (sk._ZERO, None, binv)):
            got = [sk._pass3(pass_, C, start, b, bi, sh, 4, nF, omega0=0.8,
                             s0=0.8, split=plan[0], staging=st)
                   for st in (sk.ALL_FIELDS, sk.PER_FIELD)]
            bitwise &= bool(torch.equal(*got))

        def smooth(route, st):
            return sk._smooth3_cuda(route, C, binv, b, None,
                                    [(0.8, 0.0)] * NU, sh, 4, nF, True, False,
                                    split=plan[0], staging=st)

        got = [smooth(sk.PER_PASS, st)
               for st in (sk.ALL_FIELDS, sk.PER_FIELD)]
        bitwise &= all(bool(torch.equal(a, c)) for a, c in zip(*got))
        if plan[1]:
            try:
                smooth(sk.GRID, sk.PER_FIELD)
                grid_refused = False
            except ValueError:
                pass
        if sh == STAGING_BOTH[0]:
            held = []
            for mode, pass_ in (("apply", sk._APPLY),
                                ("residual", sk._RESIDUAL)):
                for st, label in ((sk.ALL_FIELDS, "all_fields"),
                                  (sk.PER_FIELD, "per_field")):
                    rows.append(time_kernel(
                        sk.PASS3_NAMES[mode, True], [nF, *sh],
                        partial(sk._pass3, pass_, C, x, b, None, sh, 4, nF,
                                split=plan[0], staging=st),
                        bound_=bound_passes(sh, nF, [mode], 4, True),
                        radius=4, f64=True, n_fields=nF, dim=3,
                        instance=PF_TAG if st == sk.PER_FIELD
                        else instance_tag(4, True, nF),
                        staging=label, graph_launches=5,
                        library=block3_library(C, b, x, sh, 4, mode, held)
                        if st == sk.PER_FIELD else None))
            del held
        del C, binv, b, x
        torch.cuda.empty_cache()
    sh = SHAPE_PF_CHECK
    for side in (73, 81, 97):
        plans[f"{side}x{side}x{side}"] = list(
            sk._plan3((side,) * 3, 4, nF, idx, True))
    phase("kernel_check", kernel="per-field staging", shapes=STAGING_BOTH,
          plans=plans, per_field_level_launch_refused=grid_refused,
          per_field_bitwise_equal_all_fields=bitwise)
    if not bitwise:
        fail("the per-field staging differs from the all-field staging")
    if not grid_refused:
        fail("a level's one launch took the per-field staging")
    if any(plans[f"{s_}x{s_}x{s_}"][3] != sk.PER_FIELD for s_ in (73, 97)):
        fail(f"the plan does not stage one field at a time from 73³: {plans}")
    torch.cuda.reset_peak_memory_stats()
    C, binv, b, x = wide3_operands(gen, sh, dev)
    calls = block3_calls(C, binv, b, x, sh, 4, omega=1.0)
    plain = block3_calls(C, binv, b, x, sh, 4, omega=1.0, plain=True)
    errs = {}
    for mode in BLOCK3_MODES:
        name = sk.PASS3_NAMES[mode, True]
        errs[mode] = _check(worst, name, calls[mode](), plain[mode](), sh, 4,
                            quiet=True, n_fields=nF, what=mode)
        worst[name + PF_TAG] = errs[mode]
    phase("kernel_check", kernel="stencil3d_block, per-field staging",
          shape=[nF, *sh], radius=4, dtype="float64", max_abs_err=errs,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del C, binv, b, x, calls, plain
    torch.cuda.empty_cache()
    sh = SHAPE_EL3_WIDE
    C, binv, b, x = wide3_operands(gen, sh, dev)
    calls = block3_calls(C, binv, b, x, sh, 4, omega=1.0)
    plain = block3_calls(C, binv, b, x, sh, 4, omega=1.0, plain=True)
    for mode in BLOCK3_MODES:
        rows.append(time_kernel(
            sk.PASS3_NAMES[mode, True], [nF, *sh], calls[mode], plain[mode],
            bound_=bound_passes(sh, nF, [mode], 4, True), plain_launches=1,
            radius=4, f64=True, n_fields=nF, dim=3, instance=PF_TAG,
            staging="per_field", graph_launches=5))
    del C, binv, b, x, calls, plain
    torch.cuda.empty_cache()
    return rows


_RSS = {"peak": 0.0, "sampler": None}


def _rss_gib():
    """The process's resident set now, GiB (/proc/self/statm), or None."""
    with contextlib.suppress(OSError, ValueError, IndexError):
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**30
    return None


def host_peak_reset() -> None:
    """Start (once) a thread that samples the resident set every 20 ms,
    and restart the peak from the resident set now."""
    import threading

    if _RSS["sampler"] is None:
        def sample():
            while True:
                now = _rss_gib()
                if now is None:
                    return
                _RSS["peak"] = max(_RSS["peak"], now)
                time.sleep(0.02)

        _RSS["sampler"] = threading.Thread(target=sample, daemon=True)
        _RSS["sampler"].start()
    _RSS["peak"] = _rss_gib() or 0.0


def host_peak_gib():
    """The largest resident set sampled since the last reset, GiB, or None
    where /proc does not say."""
    now = _rss_gib()
    return None if now is None else max(_RSS["peak"], now)


def build_biharmonic3(n_bg: int, device, bg_degree: int = 2):
    """``demos/biharmonic.py --dim 3``'s problem at ``n_bg``: the rotated
    cube on nested grids (n_fg = 2·n_bg, P2 tetrahedra) over the quadratic
    B-spline net (n_bg + 2)³ (``bg_degree`` 3: the cubic net (n_bg + 3)³),
    BiharmonicProblem(sym=False, β = α = 5,
    filter 1e-5), assembled by the front-end at u = 0. Returns (prob, M,
    lattice shape, A, b, seconds per stage, host peak GiB per stage: the
    foreground mesh, its P2 numbering, the B-spline extraction, the
    problem; and the assembly's seconds and device peak)."""
    import torch

    from iifea_tpu_torch.mesh import bspline, generators
    from iifea_tpu_torch.models.biharmonic import BiharmonicProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system

    secs, peaks, open_ = Counter(), {}, []

    def mark():
        """Fold the peak since the last reset into every open stage."""
        now = host_peak_gib()
        for name in open_:
            if now is not None:
                peaks[name] = max(peaks.get(name, 0.0), now)
        host_peak_reset()

    @contextlib.contextmanager
    def peak_of(name):
        mark()
        open_.append(name)
        try:
            yield
        finally:
            mark()
            open_.remove(name)

    def staged(fn, name):
        def run(*a, **kw):
            with peak_of(name):
                out, dt = sync_time(lambda: fn(*a, **kw))
            secs[name] += dt
            return out
        return run

    t0 = time.perf_counter()
    targets = [(generators, "FunctionSpace"),
               (bspline.BSplineSpace3D, "transfer_matrix")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]
    with peak_of("generator"):
        for owner, name, fn in saved:
            setattr(owner, name, staged(fn, name))
        try:
            mesh, M, shape = generators.immersed_cube_bspline_problem(
                n_fg=2 * n_bg, n_bg=n_bg, bg_degree=bg_degree,
                device=device)
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
    t1 = time.perf_counter()
    with peak_of("problem"):
        prob = BiharmonicProblem(mesh, sym=False, beta_value=5.0,
                                 alpha_value=5.0, filter_tol=1e-5,
                                 device=device)
    t2 = time.perf_counter()
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    torch.cuda.reset_peak_memory_stats()
    (A, b), t_asm = sync_time(
        lambda: assemble_background_system(prob.form, u0, M))
    p2, ext = secs["FunctionSpace"], secs["transfer_matrix"]
    seconds = {"mesh": t1 - t0 - p2 - ext, "p2_numbering": p2,
               "bspline_extraction": ext, "BiharmonicProblem": t2 - t1,
               "assemble": t_asm}
    host_gib = {"generator": peaks.get("generator"),
                "p2_numbering": peaks.get("FunctionSpace"),
                "bspline_extraction": peaks.get("transfer_matrix"),
                "BiharmonicProblem": peaks.get("problem")}
    return prob, M, tuple(shape), A, b, seconds, {
        "host_peak_gib": host_gib,
        "assemble_device_peak_gib": torch.cuda.max_memory_allocated()
        / 2**30}


HOST_RUN_BH3 = (7,)      # the n_bg whose host f64 run the card's is held to


def jax_row_rel(n_bg: int, norms) -> dict:
    """The card's relative norms against the JAX package's row at n_bg."""
    return {k: abs(norms[k] - v) / v
            for k, v in zip(("L2_rel", "H1_rel", "H2_rel"),
                            JAX_ROWS_BH3[n_bg])}


def phase_small_reference_biharmonic3():
    """The 3D biharmonic against host references: at n_bg = 7 and 15 (9³
    and 17³ nets) the card's MG-GMRES and host SuperLU on the same system
    give L2_rel within 2e-2 of each other; at n_bg = 7 the card's iteration
    count is within 2 of the port's host f64 run (at 15 the host run, 684
    iterations, took ~45 s of the script: dropped); at n_bg = 7, 15 and 31
    the card's L2_rel, H1_rel and H2_rel are within JAX_ROW_REL of the JAX
    package's rows."""
    import torch

    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    for n_bg in (7, 15, 31):
        prob, M, shape, A, b, secs, _ = build_biharmonic3(n_bg, gpu)
        (u, info), dt = sync_time(lambda: bh_solve(A, b, shape))
        norms = prob.error_norms(M.mv(u))
        row = {"n_bg": n_bg, "ncp": list(shape), "route": default_route_bh(),
               "iters": info.iters, "rel_residual": rel_residual(A, b, u),
               "seconds": dt, "setup_seconds": secs, "error_norms": norms,
               "jax_row_rel_diff": jax_row_rel(n_bg, norms)}
        if n_bg < 31:
            u_lu, _ = bh_solve(A, b, shape, method="direct")
            n_lu = prob.error_norms(M.mv(u_lu))
            row.update(error_norms_lu=n_lu, l2_rel_diff=abs(
                norms["L2_rel"] - n_lu["L2_rel"]) / n_lu["L2_rel"])
        if n_bg in HOST_RUN_BH3:
            p_h, M_h, _, A_h, b_h, _, _ = build_biharmonic3(n_bg, cpu)
            (u_h, info_h), dt_h = sync_time(lambda: bh_solve(A_h, b_h,
                                                             shape))
            row.update(host_iters=info_h.iters, host_seconds=dt_h,
                       host_error_norms=p_h.error_norms(M_h.mv(u_h)))
        phase("small_reference_biharmonic3", **row)
        if not (u.is_cuda and row["rel_residual"] < 1e-10):
            fail(f"3D biharmonic n_bg={n_bg}: residual {row['rel_residual']}")
        if n_bg < 31 and not row["l2_rel_diff"] <= 2e-2:
            fail(f"3D biharmonic n_bg={n_bg}: L2_rel {norms['L2_rel']} "
                 f"against host LU's {row['error_norms_lu']['L2_rel']}")
        if n_bg in HOST_RUN_BH3 and not abs(info.iters
                                           - row["host_iters"]) <= 2:
            fail(f"3D biharmonic n_bg={n_bg}: {info.iters} iterations on "
                 f"the card, {row['host_iters']} on the host")
        if not max(row["jax_row_rel_diff"].values()) <= JAX_ROW_REL:
            fail(f"3D biharmonic n_bg={n_bg}: norms {norms} against the JAX "
                 f"row {JAX_ROWS_BH3[n_bg]}")


def phase_biharmonic3():
    """``demos/biharmonic.py --dim 3 --ref 3``'s problem, n_bg = 63 (65³ =
    274,625 background dofs, 12,002,256 P2 tetrahedra, 16.2 M foreground
    nodes): host set-up per stage with its peak resident set, the assembly,
    ``solve_ksp(gmres, pc='mg', stencil_radius=3)`` once counted per kernel,
    instance and lattice shape (no plain stencil apply on the card outside
    the coarse dense inverse), a warm solve staged (probe, hierarchy,
    Krylov), a profiled one, peak device memory; f64 residual < 1e-10 and
    L2_rel, H1_rel, H2_rel within JAX_ROW_REL of the JAX package's ref-3
    row. Then the route not taken (f32 mixed), counted and capped at
    OTHER_ROUTE_MAX_IT iterations, with its outcome: the only full-width
    run of the f32 radius-3 3D instances, whose launches the summary
    reports. Returns {instance tag: (launches by kernel, launches by
    shape)}."""
    import torch

    from iifea_tpu_torch.api import l2_norm
    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.solvers import ksp

    gpu = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, shape, A, b, setup, mem = build_biharmonic3(N_BG_BH3, gpu)
    phase("biharmonic3_setup", n_bg=N_BG_BH3, n_fg=2 * N_BG_BH3,
          lattice=list(shape), n_bg_dofs=M.n_bg_dofs,
          n_fg_nodes=prob.space.n_nodes, n_cells=prob.mesh.n_cells,
          n_block_cells=prob.cell_dom.n_elem, n_facets=prob.facet_dom.n_elem,
          extraction_entries=M.valT.numel(), eliminated=prob.elim_counts,
          seconds=setup, **mem,
          device_gib=torch.cuda.memory_allocated() / 2**30)
    route = default_route_bh()
    plain = Counter()
    with plain_on_card(plain):
        (u, info), t_first, launches, by_shape = counted_run(
            lambda: bh_solve(A, b, shape), names3(LEVELS_BH3, 3,
                                                  route == "f64"),
            "biharmonic3")
    peak = torch.cuda.max_memory_allocated() / 2**30
    relres = rel_residual(A, b, u)
    norms = prob.error_norms(M.mv(u))
    rel = jax_row_rel(N_BG_BH3, norms)
    tag = instance_tag(3, route == "f64")
    phase("biharmonic3", route=route, first_seconds=t_first,
          iters=info.iters,
          passes=len(info.history) - 1 if route == "mixed" else 1,
          rel_residual=relres, error_norms=norms,
          jax_row=JAX_ROWS_BH3[N_BG_BH3], jax_row_rel_diff=rel,
          launches=launches, launches_by_shape=by_shape,
          plain_applies_on_card=dict(plain), peak_gib=peak)
    if not relres < 1e-10:
        fail(f"biharmonic3: f64 relative residual {relres} >= 1e-10")
    if not info.iters <= MAX_GMRES_ITERS_BH3:
        fail(f"biharmonic3: {info.iters} GMRES iterations > "
             f"{MAX_GMRES_ITERS_BH3}")
    if not (u.shape == (M.n_bg_dofs,) and u.is_cuda
            and bool(torch.isfinite(u).all())):
        fail("biharmonic3: the solution is not a finite card vector of the "
             "background size")
    # per smoothed level one smooth3 launch a call, or its passes; the
    # Krylov apply at the finest level
    def launched(k, s_):
        key = f"{k}@{'x'.join(map(str, s_))}{tag}"
        return any(n > 0 for kk, n in by_shape.items()
                   if kk == key or kk.startswith(key + ":"))

    missing = [s_ for s_ in LEVELS_BH3 if not all(
        launched(k, s_)
        for k in ((("stencil_mv3",) if s_ == LEVELS_BH3[0] else ())
                  + (("smooth3",)
                     if sk._plan3(s_, 3, 1, 0, route == "f64")[1]
                     else PASSES3)))]
    if missing:
        fail(f"biharmonic3: a kernel did not launch at the smoothed shapes "
             f"{missing}: {by_shape}")
    if plain["elsewhere"]:
        fail(f"biharmonic3: {plain['elsewhere']} plain stencil applies on "
             "the card outside the coarse dense inverse")
    if not max(rel.values()) <= JAX_ROW_REL_63:
        fail(f"biharmonic3: norms {norms} against the JAX row "
             f"{JAX_ROWS_BH3[N_BG_BH3]}: {rel}")
    if not peak < PEAK_GIB:
        fail(f"biharmonic3: peak device memory {peak} GiB")

    # one warm solve staged (PERF.md §5 keeps the earlier three and the
    # 1e-12 solve)
    stages = Counter()
    with timed_calls([(ksp, "_probe_general"),
                      (multigrid, "StencilMultigrid3D")], stages):
        (_, info_w), t_w = sync_time(lambda: bh_solve(A, b, shape))
    run = {"solve_ksp": t_w, "probe": stages["_probe_general"],
           "hierarchy": stages["StencilMultigrid3D"],
           "krylov": t_w - sum(stages.values()), "iters": info_w.iters}
    phase("biharmonic3_stages", setup=setup, warm=run)
    # profiled over one GMRES(100) cycle of the solve (its probe and
    # hierarchy whole): the profiler's bookkeeping of all 520 iterations'
    # 59 k launches took the phase's largest share after the host set-up
    profile_solve(lambda: bh_solve(A, b, shape, gmres_restart=100, max_it=0),
                  "biharmonic3_profile")

    other = "mixed" if route == "f64" else "f64"
    torch.cuda.reset_peak_memory_stats()
    (u_o, info_o), t_o, launches_o, by_shape_o = counted_run(
        lambda: bh_solve(A, b, shape, mixed=other == "mixed",
                         max_it=OTHER_ROUTE_MAX_IT),
        names3(LEVELS_BH3, 3, other == "f64"),
        "biharmonic3_other_route")
    relres_o = rel_residual(A, b, u_o)
    u_f = M.mv(u)
    norms_o = prob.error_norms(M.mv(u_o))
    phase("biharmonic3_other_route", route=other, seconds=t_o,
          iters=info_o.iters,
          passes=len(info_o.history) - 1 if other == "mixed" else 1,
          history=info_o.history if other == "mixed" else None,
          rel_residual=relres_o, converged=relres_o < 1e-10,
          error_norms=norms_o,
          norms_rel_diff_from_route={k: abs(norms_o[k] - norms[k]) / norms[k]
                                     for k in norms},
          l2_diff_from_route=l2_norm(M.mv(u_o) - u_f, prob.cell_dom)
          / l2_norm(u_f, prob.cell_dom),
          launches=launches_o, launches_by_shape=by_shape_o,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return {tag: (launches, by_shape),
            instance_tag(3, other == "f64"): (launches_o, by_shape_o)}


def phase_demo_biharmonic3():
    """The 3D biharmonic demo on the card (the ``main`` of ``python3 -m
    iifea_tpu_torch.demos.biharmonic --dim 3 --ref 0``, in this process:
    n_bg = 7), held against the same demo on the host: the same iteration
    count, norms equal to DEMO_NORMS_BH relative."""
    biharmonic_demo(["--dim", "3", "--ref", "0"], "demo_biharmonic3")


# the Navier-Stokes Taylor-Green vortex (demos/tg_vortex.py --mesh-root
# synthetic --solv gmres --pc mg): the small reference at ref 2 over the
# whole interval (JAX RESULTS.md's row: L2u, H1u, L2p), the cell at ref 7
NS_SMALL = ["--ref", "2", "--T", "1.0", "--mesh-root", "synthetic",
            "--solv", "gmres", "--pc", "mg"]
NS_JAX_ROW = {"L2u": 0.001513, "H1u": 0.04738, "L2p": 0.4106}
NS_JAX_REL = 1e-2     # the JAX row is printed to 4 digits
NS_HOST_REL = 1e-6    # the card's norms against the port's own host run
NS_FULL = ["--k", "1", "--ref", "7", "--Re", "100", "--T", "0.008",
           "--mesh-root", "synthetic", "--solv", "gmres", "--pc", "mg",
           "--pin-pressure", "True"]
NS_MAX_L2U = 3.915e-4    # the JAX ref-3 row at T = 1: ref 7 must be below
NS_LEVELS = [(s_, s_) for s_ in (513, 257, 129, 65, 33, 17)]


@contextlib.contextmanager
def newton_record(steps: list):
    """Record every ``solve_nonlinear`` call (a time step) while the block
    runs: per step ([(iterations, converged) of each linear solve, one per
    Newton iteration], synced seconds). The demos import
    ``solve_nonlinear`` from ``iifea_tpu_torch.solvers`` when they run, and
    the Newton loop calls ``newton.solve_ksp``; both are wrapped."""
    import iifea_tpu_torch.solvers as solvers
    from iifea_tpu_torch.solvers import newton

    outer, inner = solvers.solve_nonlinear, newton.solve_ksp

    def stepped(*a, **kw):
        steps.append([])
        out, dt = sync_time(lambda: outer(*a, **kw))
        steps[-1] = (steps[-1], dt)
        return out

    def solved(*a, **kw):
        x, info = inner(*a, **kw)
        steps[-1].append((int(info.iters), bool(info.converged)))
        return x, info

    solvers.solve_nonlinear, newton.solve_ksp = stepped, solved
    try:
        yield
    finally:
        solvers.solve_nonlinear, newton.solve_ksp = outer, inner


def tg_demo(argv, device: str):
    """The Taylor-Green demo in this process on ``device``, its printed
    report kept apart; returns (the demo's result, per-step linear solves,
    seconds)."""
    import io

    from iifea_tpu_torch.demos import tg_vortex

    steps = []
    with newton_record(steps), contextlib.redirect_stdout(io.StringIO()):
        out, dt = sync_time(lambda: tg_vortex.main(argv + ["--device",
                                                           device]))
    return out, steps, dt


def phase_navier_stokes():
    """The Taylor-Green vortex through the port's demo (the user's entry
    point). Small reference: ref 2 over T = 1 without the pin, on the card
    and on the host: the same Newton iterations per step, norms within
    NS_HOST_REL of the host's and NS_JAX_REL of the JAX package's row.
    Then the cell: ref 7 (n_bg = 512, 3 × 513² = 789,507 dofs, 2,097,152
    triangles), 3 midpoint steps, the pressure pinned, counted per kernel
    and lattice shape with every counter set to 0 just before, staged
    (assembly, probe, hierarchy, Krylov), and once more profiled. Gates:
    every step converged in ≤ 10 Newton iterations, every linear solve
    converged, L2u below NS_MAX_L2U, launches of the three-field instances
    at every smoothed level shape, no plain stencil apply on the card
    outside the dense coarse inverse. Returns (launches by kernel, by
    shape) of the counted run."""
    import torch

    from iifea_tpu_torch.ops import assembly, multigrid
    from iifea_tpu_torch.solvers import ksp, newton as newton_mod

    card, card_steps, t_card = tg_demo(NS_SMALL, "cuda")
    host, host_steps, t_host = tg_demo(NS_SMALL, "cpu")
    keys = list(NS_JAX_ROW)
    rel_host = {k: abs(card["norms"][k] - host["norms"][k])
                / host["norms"][k] for k in keys}
    rel_jax = {k: abs(card["norms"][k] - v) / v
               for k, v in NS_JAX_ROW.items()}
    newton = [len(st) for st, _ in card_steps]
    host_newton = [len(st) for st, _ in host_steps]
    phase("navier_stokes_small", argv=NS_SMALL, steps=card["n_steps"],
          seconds=t_card, host_seconds=t_host, newton_iters=newton,
          host_newton_iters=host_newton,
          gmres_iters=[[i for i, _ in st] for st, _ in card_steps],
          host_gmres_iters=[[i for i, _ in st] for st, _ in host_steps],
          error_norms=card["norms"], host_error_norms=host["norms"],
          norms_rel_diff_host=rel_host, norms_rel_diff_jax=rel_jax)
    if newton != host_newton:
        fail(f"navier_stokes_small: Newton iterations per step {newton} "
             f"differ from the host's {host_newton}")
    if not max(rel_host.values()) <= NS_HOST_REL:
        fail(f"navier_stokes_small: card norms {card['norms']} differ from "
             f"the host's {host['norms']} by {rel_host}")
    if not max(rel_jax.values()) <= NS_JAX_REL:
        fail(f"navier_stokes_small: norms {card['norms']} differ from the "
             f"JAX row {NS_JAX_ROW} by {rel_jax}")
    del card, host
    torch.cuda.empty_cache()

    # -- the cell: ref 7, counted and staged -----------------------------------
    names = ("stencil_mv_block", "jacobi_smooth", "smooth")
    plain, stages, steps = Counter(), Counter(), []
    targets = [(assembly.Form, "jacobian_and_residual"),
               (ksp, "_probe_block"), (multigrid, "StencilMultigridBlock"),
               (ksp, "_deflation_space"), (newton_mod, "solve_ksp")]
    with plain_on_card(plain), timed_calls(targets, stages):
        out, seconds, launches, by_shape = counted_run(
            lambda: tg_demo(NS_FULL, "cuda"), names, "navier_stokes")
    out, steps, _ = out
    peak = torch.cuda.max_memory_allocated() / 2**30
    newton = [len(st) for st, _ in steps]
    step_s = [dt for _, dt in steps]
    steps = [st for st, _ in steps]
    solve = stages["solve_ksp"]
    staged = {"assembly": stages["jacobian_and_residual"],
              "probe": stages["_probe_block"],
              "hierarchy": stages["StencilMultigridBlock"],
              "deflation": stages["_deflation_space"],
              "krylov": solve - stages["_probe_block"]
              - stages["StencilMultigridBlock"] - stages["_deflation_space"]}
    # the Newton steps' other work (residual norms, extraction, updates)
    staged["other_in_steps"] = sum(step_s) - staged["assembly"] - solve
    phase("navier_stokes", argv=NS_FULL, n_bg_dofs=out["M"].n_bg_dofs,
          steps=out["n_steps"], Dt=out["Dt"], seconds=seconds,
          step_seconds=step_s, setup_and_norms_seconds=seconds - sum(step_s),
          newton_iters=newton,
          gmres_iters=[[i for i, _ in st] for st in steps],
          stage_seconds=staged, launches=launches, launches_by_shape=by_shape,
          plain_applies_on_card=dict(plain), peak_gib=peak,
          error_norms=out["norms"])
    if not (out["n_steps"] == 3 and len(steps) == 3
            and all(1 <= n <= 10 for n in newton)):
        fail(f"navier_stokes: steps {out['n_steps']}, Newton iterations "
             f"{newton}")
    if not all(ok for st in steps for _, ok in st):
        fail(f"navier_stokes: a linear solve did not converge: {steps}")
    if not (out["up_f"].is_cuda and bool(torch.isfinite(out["up_f"]).all())
            and out["norms"]["L2u"] < NS_MAX_L2U):
        fail(f"navier_stokes: L2u {out['norms']['L2u']} not below "
             f"{NS_MAX_L2U}, or the state is not a finite card vector")
    missing = [s_ for s_ in NS_LEVELS if not any(
        by_shape.get(f"{k}@{N_FIELDS_NS}x{s_[0]}x{s_[1]}", 0) > 0
        for k in names)]
    if missing:
        fail(f"navier_stokes: no three-field launch at {missing}: "
             f"{by_shape}")
    if plain["elsewhere"]:
        fail(f"navier_stokes: {plain['elsewhere']} plain stencil applies on "
             "the card outside the coarse dense inverse")
    # a steady window for the profile: one more time step from the cell's
    # final state, as the demo takes it
    import io

    from iifea_tpu_torch.solvers import solve_nonlinear

    t_next = out["t"] + 0.5 * out["Dt"]

    def next_step():
        with contextlib.redirect_stdout(io.StringIO()):
            return solve_nonlinear(out["prob"].form, out["up_f"], out["M"],
                                   out["up_p"], aux={"up_old": out["up_f"]},
                                   params={"t": t_next},
                                   **out["step_kwargs"])

    profile_solve(next_step, "navier_stokes_profile")
    return launches, by_shape


# the Kirchhoff-Love shells through the port's demos at their defaults (ref
# 4: 32,768 P2 triangles, 198,147 foreground dofs, a 66² quadratic B-spline
# net with three fields, 13,068 background dofs), held to the JAX package's
# full-precision golds (studies/unfitted.jsonl); the small reference is the
# pinned demo at --ref 1, card against the port's host run
SHELL_GOLDS = {"pinned": 0.013311397557701023, "cut": 0.4453083791096255}
SHELL_GOLD_REL = 1e-6
SHELL_HOST_REL = 1e-8
# poisson_unfitted at n = 16, 32, 64: (L2, H1) of studies/unfitted.jsonl
PU_ROWS = {16: (0.8324617710388913, 4.619121793635782),
           32: (0.2184733048760064, 1.8485587849773495),
           64: (0.05876376557410996, 0.8371992158395066)}
PU_REL = 1e-8
DET_REPEATS = 3               # repeats of the Taylor-Green first step


def demo_in_process(module, argv, device: str):
    """A demo's ``main`` in this process on ``device``, its printed report
    kept apart, the kernel wrappers' launch counters set to 0 just before
    and read just after; returns (result, seconds, the launches that
    happened by kernel, peak device GiB)."""
    import io

    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    torch.cuda.reset_peak_memory_stats()
    sk.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        out, dt = sync_time(lambda: module.main(argv + ["--device", device]))
    launched = {k: v for k, v in sk.launches().items() if v}
    return out, dt, launched, torch.cuda.max_memory_allocated() / 2**30


def newton_stages(record) -> dict:
    """A Newton record's seconds per stage, per iteration: the device
    assembly (element Hessians, residual, Mᵀr), the host's Mᵀ A_f M
    (``to_scipy``) and its sparse LU (``direct_solve``)."""
    return {k: [rec[k] for rec in record]
            for k in ("assembly", "to_scipy", "direct_solve")}


def phase_shells():
    """The Kirchhoff-Love shells through the port's two background-unfitted
    demos (the user's entry points). Small reference: the pinned demo at
    --ref 1 on the card and on the host, the same Newton iterations and
    the centre displacement to SHELL_HOST_REL. Then the pinned demo at its
    defaults, profiled (device busy share), and the cut demo at its
    defaults (10 load steps): each held to its JAX gold to SHELL_GOLD_REL,
    the pinned centre's in-plane components below 1e-10; per Newton
    iteration the device assembly and the host's to_scipy and LU seconds,
    Newton iterations per step, launches, peak device and host memory.
    (The pinned demo's --ref 5 size row, 16 s with no gate but a finite
    displacement, was dropped to keep the script within its time.) No
    stencil kernel is on this path: the linear solves are host LU."""
    import torch

    from iifea_tpu_torch.demos.background_unfitted import (
        cut_shell_unfitted as cut,
        pinned_shell_unfitted as pinned,
    )

    card, t_card, _, _ = demo_in_process(pinned, ["--ref", "1"], "cuda")
    host, t_host, _, _ = demo_in_process(pinned, ["--ref", "1"], "cpu")
    rel = abs(card["disp"][2] - host["disp"][2]) / abs(host["disp"][2])
    phase("shells_small", argv=["--ref", "1"], seconds=t_card,
          host_seconds=t_host, newton_iters=card["newton_iters"],
          host_newton_iters=host["newton_iters"], disp=card["disp"],
          host_disp=host["disp"], disp_z_rel_diff_host=rel)
    if card["newton_iters"] != host["newton_iters"]:
        fail(f"shells_small: Newton iterations {card['newton_iters']} differ "
             f"from the host's {host['newton_iters']}")
    if not rel <= SHELL_HOST_REL:
        fail(f"shells_small: disp_z {card['disp'][2]} differs from the "
             f"host's {host['disp'][2]} by {rel}")
    del card, host

    for kind, module in (("pinned", pinned), ("cut", cut)):
        host_peak_reset()
        res = {}

        def run():
            res["out"] = demo_in_process(module, [], "cuda")

        if kind == "pinned":
            profile_solve(run, "shells_pinned_profile")
        else:
            run()
        out, seconds, launched, peak = res["out"]
        value = out["disp"][2] if kind == "pinned" else out["tip"][2]
        rel = abs(value - SHELL_GOLDS[kind]) / SHELL_GOLDS[kind]
        record = (out["record"] if kind == "pinned"
                  else [rec for step in out["record"] for rec in step])
        stages = newton_stages(record)
        phase(f"shells_{kind}", n_bg_dofs=out["M"].n_bg_dofs,
              n_fg_dofs=out["prob"].space.n_dofs,
              block_cells=out["prob"].cell_dom.n_elem, seconds=seconds,
              stage_seconds=out["stage_seconds"],
              newton_iters=out["newton_iters"],
              stage_totals={k: sum(v) for k, v in stages.items()},
              per_iteration=stages, value=value, gold=SHELL_GOLDS[kind],
              rel_diff_gold=rel, launches=launched, peak_gib=peak,
              host_peak_gib=host_peak_gib(),
              displacement=out["disp"] if kind == "pinned" else out["tip"])
        if not (out["u_f"].is_cuda and rel <= SHELL_GOLD_REL):
            fail(f"shells_{kind}: {value} not within {SHELL_GOLD_REL} of "
                 f"the JAX gold {SHELL_GOLDS[kind]}, or not on the card")
        if kind == "pinned" and not max(map(abs, out["disp"][:2])) < 1e-10:
            fail(f"shells_pinned: in-plane centre displacement "
                 f"{out['disp'][:2]}")
        del out, res
        torch.cuda.empty_cache()


def phase_poisson_unfitted():
    """``python3 -m iifea_tpu_torch.demos.background_unfitted.poisson_unfitted
    --n 16, 32, 64`` on the card (runtime P1 transfer matrix, host LU):
    L2 and H1 within PU_REL of the JAX package's rows."""
    from iifea_tpu_torch.demos.background_unfitted import poisson_unfitted

    for n, (l2, h1) in PU_ROWS.items():
        out, seconds, _, peak = demo_in_process(poisson_unfitted,
                                                ["--n", str(n)], "cuda")
        rel = {"L2": abs(out["L2"] - l2) / l2, "H1": abs(out["H1"] - h1) / h1}
        phase("poisson_unfitted", n=n, seconds=seconds, L2=out["L2"],
              H1=out["H1"], jax_row=[l2, h1], rel_diff=rel, peak_gib=peak)
        if not (out["u_f"].is_cuda and max(rel.values()) <= PU_REL):
            fail(f"poisson_unfitted --n {n}: norms {out['L2']}, "
                 f"{out['H1']} not within {PU_REL} of {l2}, {h1}")


def _digest(t) -> str:
    import hashlib

    t = getattr(t, "coeffs", t)
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def tg_cell(device: str = "cuda", argv=None, pinned: bool = True):
    """The Taylor-Green ref-7 cell (or the demo run ``argv`` asks for) set
    up from nothing as the demo does (mesh, problem, L2 projection,
    pressure pin unless not ``pinned``): (prob, M, up_p, up_f, the pinned
    dofs, the lattice shape, t of the first step's midpoint)."""
    import numpy as np
    import torch

    from iifea_tpu_torch.api import l2_project
    from iifea_tpu_torch.demos import tg_vortex
    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.navier_stokes import (
        TaylorGreenProblem,
        u_exact,
    )

    args = tg_vortex.parse_args(NS_FULL if argv is None else argv)
    n = 8 * 2 ** int(args.ref)
    mesh, M = immersed_square_problem(n_fg=n, n_bg=n // 2, n_fields=3,
                                      device=device)
    steps = math.ceil(float(args.T) / (4 / math.sqrt(mesh.n_cells)))
    Dt = float(args.T) / steps
    prob = TaylorGreenProblem(mesh, k=1, Re=float(args.Re), Dt=Dt,
                              n_bg_dofs=M.n_bg_dofs, device=device)

    def ic(x):
        return torch.cat([u_exact(x, prob.nu, 0.0), torch.zeros_like(x[:1])])

    up_p, up_f = l2_project(ic, prob.space, prob.cell_dom, M)
    pin = (tg_vortex.pressure_pin(prob, M, up_f, up_f) if pinned
           else np.zeros(0, dtype=np.int64))
    return prob, M, up_p, up_f, pin, (n // 2 + 1,) * 2, 0.5 * Dt


def tg_first_system(prob, M, up_p, up_f, pin, t):
    """The first Newton iteration's (A, b, element blocks, foreground
    residual), as ``solve_nonlinear`` forms them."""
    from iifea_tpu_torch.ops.projection import BackgroundOperator
    from iifea_tpu_torch.solvers.trim import apply_trim_rhs, mask_from_ids

    blocks, res = prob.form.jacobian_and_residual(up_f, {"up_old": up_f},
                                                  {"t": t})
    mask = mask_from_ids(pin, M.n_bg_dofs, device=up_p.device)
    A = BackgroundOperator(prob.form, blocks, M).with_trim(mask)
    return A, apply_trim_rhs(M.rmv(res), mask, target=up_p), blocks, res


def tg_solve(A, b, shape, planes: list):
    """The demo's first linear solve (``solve_nonlinear``'s defaults; the
    mixed route, as on a card by default), the probe's planes appended to
    ``planes``; returns (x, info)."""
    from iifea_tpu_torch.solvers import ksp

    probe = ksp._probe_block

    def kept(*a, **kw):
        planes.append(probe(*a, **kw))
        return planes[-1]

    ksp._probe_block = kept
    try:
        return ksp.solve_ksp(A, b, method="gmres", pc="mg", rtol=1e-8,
                             atol=1e-9, lattice_shape=shape, n_fields=3,
                             monitor=False, mixed=True)
    finally:
        ksp._probe_block = probe


def tg_first_solve(keep=None):
    """The cell set up from nothing and its first linear solve; returns
    (GMRES iterations, digests of the initial state, the rhs, the planes,
    the solution). ``keep``, a dict, gets the system (A, b, shape)."""
    prob, M, up_p, up_f, pin, shape, t = tg_cell()
    A, b, _, _ = tg_first_system(prob, M, up_p, up_f, pin, t)
    planes = []
    x, info = tg_solve(A, b, shape, planes)
    if keep is not None:
        keep.update(A=A, b=b, shape=shape)
    return (int(info.iters), {"state": _digest(up_f), "rhs": _digest(b),
                              "planes": _digest(planes[0]),
                              "solution": _digest(x)})


def phase_determinism():
    """Run-to-run determinism (ROADMAP §3 P5). The Taylor-Green ref-7
    cell's first linear solve, set up from nothing DET_REPEATS times in
    this process: the initial state, the rhs, the probe's planes and the
    solution bitwise equal in every repeat, and the same GMRES count; then
    two block probes of the elasticity n_bg=512 operator give bitwise-
    equal planes."""
    import torch

    from iifea_tpu_torch.solvers import ksp

    runs, kept = [], {}
    for k in range(DET_REPEATS):
        runs.append(sync_time(lambda: tg_first_solve(
            kept if k == DET_REPEATS - 1 else None)))
        torch.cuda.empty_cache()
    iters = [r[0][0] for r in runs]
    digests = [r[0][1] for r in runs]
    phase("determinism_taylor_green", repeats=DET_REPEATS,
          gmres_iters=iters, digests=digests,
          seconds=[r[1] for r in runs])
    if len(set(iters)) != 1 or any(d != digests[0] for d in digests):
        fail(f"determinism: the Taylor-Green first solve differs between "
             f"repeats: iterations {iters}, digests {digests}")
    if F64_ON["on"]:
        # the f64 route on the cell's first system (the last repeat's)
        A, b, shape = kept["A"], kept["b"], kept["shape"]
        f64_route("taylor_green", instance_tag(2, True, N_FIELDS_NS),
                  lambda: ksp.solve_ksp(
                      A, b, method="gmres", pc="mg", rtol=1e-8, atol=1e-9,
                      lattice_shape=shape, n_fields=N_FIELDS_NS,
                      monitor=False, mixed=False),
                  A, b, block_names(2, NS_LEVELS, 2, N_FIELDS_NS, True),
                  mixed_iters=iters[0], gate_rel=False)
    kept.clear()
    _, _, A, _, _ = build_elasticity(N_BG_EL, "cuda")
    probes = [sync_time(lambda: ksp._probe_block(
        A, (N_BG_EL + 1,) * 2, N_FIELDS_EL, 2, torch.float32))
        for _ in range(2)]
    planes = [_digest(S) for S, _ in probes]
    phase("determinism_elasticity_probe", n_bg=N_BG_EL, planes=planes,
          probe_seconds=[t for _, t in probes])
    if planes[0] != planes[1]:
        fail(f"determinism: two elasticity probes differ: {planes}")


# the mesh-file door (phase mesh_files): the Kirsch plate at the size of the
# reference's largest hole_in_plate mesh (72,076 vertices), built in memory,
# its extraction written and read back through the port's CSV readers
PLATE_N = 190            # P1: (2n+1)(n+1) = 72,771 vertices
PLATE_N_BG = 136         # B-spline spans a side, h_bg ≈ 2 h_fg
PLATE_N2 = 95            # P2: 72,771 P2 nodes on (2n+1)(n+1) vertices
PLATE_N_BG2 = 68
PLATE_RATE = 1.7         # JAX's test_elasticity_kirsch_convergence criterion
PLATE_CPU_REL = 1e-8     # the quarter-size card run against the host's
P2_SHUFFLE_N_BG = 63     # the P2 Poisson square: a 65² spline net
P2_SHUFFLE_REL = 1e-10   # its system and norms, Exodus-shuffled vs own
DIRECT_RES = 1e-10       # relative residual of every direct solve
KRYLOV_RTOL = 1e-8       # the Krylov solves' rtol (solve_ksp's default)


def plate_files(tmp, n, n_bg, k, device, seed=0):
    """The Kirsch plate of degree k at n through the mesh-file door: the
    fitted plate and its trimmed B-spline triples built in memory
    (``host_mesh``), written as ExOp_Cons.csv (and for P2 cell_nodes.csv on
    shuffled Exodus ids: ``csv_write``) and read back by the port's readers
    (``csv_read``: the files' M on ``device``); the P2 plate is marked 1 in
    its files and flipped back, as the reference's quadratic files are.
    Returns (mesh, M read, M of the in-memory triples (host), stage
    seconds)."""
    import tempfile

    import numpy as np

    from iifea_tpu_torch.demos import linear_elasticity as le
    from iifea_tpu_torch.mesh import io
    from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
    from iifea_tpu_torch.mesh.generators import (
        bspline_triples,
        quarter_plate_mesh,
    )
    from iifea_tpu_torch.ops.extraction import ExtractionOperator

    stages = {}
    t = time.perf_counter()
    mesh = quarter_plate_mesh(n, material=2 if k == 1 else 1)
    space = FunctionSpace(mesh, degree=k)
    fg, bg, w = bspline_triples(space.node_coords, n_bg, (0.0, 0.0),
                                (4.0, 4.0))
    cn = None
    if k == 2:
        ids = np.random.default_rng(seed).permutation(space.n_nodes)
        fg, cn = ids[fg], ids[space.cell_dofs]
    stages["host_mesh"] = time.perf_counter() - t
    d = tempfile.mkdtemp(dir=tmp)
    exop, cn_path = (os.path.join(d, "ExOp_Cons.csv"),
                     os.path.join(d, "cell_nodes.csv"))
    t = time.perf_counter()
    io.write_exop_triples(exop, fg, bg, w)
    if cn is not None:
        io.write_cell_nodes(cn_path, cn)
    stages["csv_write"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh = Mesh(mesh.coords, mesh.cells, mesh.material,
                None if cn is None else io.read_cell_nodes(cn_path))
    if k == 2:
        mesh = le.flip_materials(mesh)
    n_nodes = FunctionSpace(mesh, degree=k).n_nodes
    M = ExtractionOperator.from_exop_csv(exop, n_nodes, n_fields=2,
                                         device=device)
    stages["csv_read"] = time.perf_counter() - t
    M_mem = ExtractionOperator.from_triples(fg, bg, w, n_nodes, n_fields=2,
                                            device="cpu")
    return mesh, M, M_mem, stages


def plate_solve(mesh, M, k, device, argv=()):
    """``demos/linear_elasticity.kirsch`` (the demo's file branch after the
    read) on ``device``, its report kept apart; returns its result with
    ``rel_residual`` ‖A u − b‖/‖b‖ on the operator it solved."""
    import io as io_

    from iifea_tpu_torch.demos import linear_elasticity as le

    args = le.parse_args(["--k", str(k), *argv])
    with contextlib.redirect_stdout(io_.StringIO()):
        out = le.kirsch(mesh, M, args, device)
    A, b, u = out["A"], out["b"], out["u_p"]
    out["rel_residual"] = float((A.mv(u) - b).norm() / b.norm())
    return out


def p2_shuffle(tmp, device) -> dict:
    """P2 Poisson on the generated square (nested quadratic B-splines,
    n_bg = P2_SHUFFLE_N_BG), its triples trimmed to the background
    functions nonzero at a node of the block, as the reference's files
    are: once on the port's own P2 numbering with M from the triples in
    memory, once on a shuffled Exodus numbering whose cell_nodes.csv and
    ExOp_Cons.csv went through the files (the background numbering is the
    same). Returns the two projected systems' largest relative
    differences (A by to_scipy, b), the norms of the own system's host-LU
    solution through each numbering's M and error integrals, the norms of
    the shuffled system's own LU solution, both relative residuals, each
    system's plain SuperLU backward error under four steps of iterative
    refinement (``lu_refinement``: a stable factorization stagnates, an
    unstable one grows, and solve_direct then trims the system), and the
    P2 node and kept background function counts."""
    import tempfile

    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    from iifea_tpu_torch.mesh import io
    from iifea_tpu_torch.mesh.core import FunctionSpace, Mesh
    from iifea_tpu_torch.mesh.generators import (
        exop_triples,
        immersed_square_bspline_problem,
    )
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.ops.extraction import ExtractionOperator
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.solvers.ksp import solve_ksp

    def system(mesh, M):
        prob = PoissonProblem(mesh, k=2, sym=True, beta_value=10.0,
                              device=device)
        u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                         device=device)
        A, b = assemble_background_system(prob.form, u0, M)
        u, _ = solve_ksp(A, b, method="direct", monitor=False)
        return prob, A, b, u, float((A.mv(u) - b).norm() / b.norm())

    def lu_refinement(S, b):
        S, b = S.tocsc(), b.cpu().numpy()
        lu = spla.splu(S)
        x, out = lu.solve(b), []
        for _ in range(5):
            out.append(float(np.linalg.norm(S @ x - b) / np.linalg.norm(b)))
            x = x + lu.solve(b - S @ x)
        return out

    mesh, M_lattice, _ = immersed_square_bspline_problem(
        n_fg=2 * P2_SHUFFLE_N_BG, n_bg=P2_SHUFFLE_N_BG, device=device)
    space = FunctionSpace(mesh, degree=2)
    fg, bg, w = exop_triples(
        M_lattice, np.unique(space.cell_dofs[mesh.material == 2]))
    M = ExtractionOperator.from_triples(fg, bg, w, space.n_nodes,
                                        device=device)
    prob, A, b, u, res = system(mesh, M)
    ids = np.random.default_rng(1).permutation(space.n_nodes)
    d = tempfile.mkdtemp(dir=tmp)
    io.write_exop_triples(os.path.join(d, "ExOp_Cons.csv"), ids[fg], bg, w)
    io.write_cell_nodes(os.path.join(d, "cell_nodes.csv"),
                        ids[space.cell_dofs])
    mesh_x = Mesh(mesh.coords, mesh.cells, mesh.material,
                  io.read_cell_nodes(os.path.join(d, "cell_nodes.csv")))
    M_x = ExtractionOperator.from_exop_csv(
        os.path.join(d, "ExOp_Cons.csv"), space.n_nodes, device=device)
    prob_x, A_x, b_x, u_x, res_x = system(mesh_x, M_x)
    S, S_x = A.to_scipy(), A_x.to_scipy()
    return {"A_rel_diff": abs(S - S_x).max() / abs(S).max(),
            "b_rel_diff": float((b - b_x).abs().max() / b.abs().max()),
            "norms": prob.error_norms(M.mv(u)),
            "norms_shuffled": prob_x.error_norms(M_x.mv(u)),
            "norms_shuffled_own_solve": prob_x.error_norms(M_x.mv(u_x)),
            "lu_refinement": {"own": lu_refinement(S, b),
                              "shuffled": lu_refinement(S_x, b_x)},
            "rel_residuals": (res, res_x), "n_p2_nodes": space.n_nodes,
            "n_bg_kept": M.n_bg_dofs, "n_bg_lattice": M_lattice.n_bg_dofs}


def phase_mesh_files():
    """The mesh-file door on the card (``mesh/io``'s CSV readers,
    ``ExtractionOperator.from_exop_csv``, the Kirsch ``ElasticityProblem``
    through ``demos/linear_elasticity.kirsch``; no stencil kernel: the
    files' background is no lattice). The card machine has no h5py, so
    the meshes are built in memory and only the CSV files go through the
    disk. The P1 plate at PLATE_N (72,771 vertices) by host SuperLU,
    profiled, with its stages; at a quarter of the size on the card and on
    the host; the P2 plate (72,771 P2 nodes, Exodus ids shuffled) by
    SuperLU and by GMRES with asm and with Jacobi; a P2 Poisson square on
    shuffled Exodus ids against the port's own numbering. Gates: direct
    residuals ≤ DIRECT_RES and Krylov ones ≤ KRYLOV_RTOL; the P1 stress
    error falls by more than PLATE_RATE from the quarter to the full size;
    P2's error below P1's; asm within Jacobi's iterations; the quarter
    size card vs host ≤ PLATE_CPU_REL; M read from the CSV bitwise the
    in-memory triples' M; the shuffled P2 system (A, b) and the norms of
    one solution through each numbering ≤ P2_SHUFFLE_REL. (Each system's
    own LU solution is reported, not gated: the two systems agree to
    ~1e-15, but SuperLU's plain factorization of one diverges under
    refinement where the other's is stable (``lu_refinement``), so
    solve_direct trims that system and its norms move by ~1e-7.)"""
    import tempfile

    import torch

    gpu, cpu = torch.device("cuda", 0), torch.device("cpu")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    norms, relres, iters, dofs, same_M = {}, {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh, M, M_mem, _ = plate_files(tmp, PLATE_N // 2, PLATE_N_BG // 2,
                                        1, gpu)
        same_M["k1_quarter"] = (M.to_scipy() != M_mem.to_scipy()).nnz == 0
        card = plate_solve(mesh, M, 1, gpu)
        M_host = type(M)(M.idx_np, M.val_np, M.n_bg_dofs, cpu)
        host = plate_solve(mesh, M_host, 1, cpu)
        for tag, out in (("k1_quarter", card), ("k1_quarter_host", host)):
            norms[tag], relres[tag] = out["norm"], out["rel_residual"]
        cpu_rel = abs(card["norm"] - host["norm"]) / host["norm"]
        del card, host, M_host

        mesh, M, M_mem, stages = plate_files(tmp, PLATE_N, PLATE_N_BG, 1,
                                             gpu)
        same_M["k1"] = (M.to_scipy() != M_mem.to_scipy()).nnz == 0
        res = {}
        profiled = profile_stats(
            lambda: res.update(out=plate_solve(mesh, M, 1, gpu)))
        out = res["out"]
        stages.update(out["stage_seconds"])
        norms["k1"], relres["k1"] = out["norm"], out["rel_residual"]
        dofs["k1"] = {"n_verts": mesh.n_verts, "n_cells": mesh.n_cells,
                      "n_fg_dofs": M.n_fg_dofs, "n_bg_dofs": M.n_bg_dofs}
        on_card = out["u_p"].is_cuda
        del out, res

        mesh, M, M_mem, stages2 = plate_files(tmp, PLATE_N2, PLATE_N_BG2, 2,
                                              gpu)
        same_M["k2"] = (M.to_scipy() != M_mem.to_scipy()).nnz == 0
        dofs["k2"] = {"n_p2_nodes": M.n_fg_dofs // 2,
                      "n_fg_dofs": M.n_fg_dofs, "n_bg_dofs": M.n_bg_dofs}
        seconds2 = {}
        for tag, argv in (("k2", []),
                          ("k2_asm", ["--solv", "gmres", "--pc", "asm"]),
                          ("k2_jacobi", ["--solv", "gmres", "--pc",
                                         "jacobi"])):
            out, seconds2[tag] = sync_time(
                lambda: plate_solve(mesh, M, 2, gpu, argv))
            norms[tag], relres[tag] = out["norm"], out["rel_residual"]
            if out["info"] is not None:
                iters[tag] = {"iters": out["info"].iters,
                              "converged": bool(out["info"].converged)}
            on_card = on_card and out["u_p"].is_cuda
        del out, mesh, M, M_mem

        p2 = p2_shuffle(tmp, gpu)
    relres["p2_own"], relres["p2_shuffled"] = p2.pop("rel_residuals")
    own, shuffled = p2["norms"], p2["norms_shuffled"]
    p2_rel = max([p2["A_rel_diff"], p2["b_rel_diff"]]
                 + [abs(shuffled[k] - own[k]) / own[k] for k in own])
    rate = norms["k1_quarter"] / norms["k1"]
    seconds = time.perf_counter() - t0
    phase("mesh_files", stages_k1=stages, stages_k2=stages2,
          solve_seconds_k2=seconds2, dofs=dofs, p2_shuffle=p2,
          stress_error=norms, rate_quarter_to_full=rate,
          quarter_card_vs_host=cpu_rel, rel_residual=relres,
          krylov=iters, M_csv_bitwise=same_M, p2_shuffle_rel_diff=p2_rel,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
          device_idle_share=profiled.get("device_idle_share",
                                         "not measured"),
          device_busy_seconds=profiled.get("device_busy_seconds"),
          kernel_launches=profiled.get("kernel_launches"),
          top=profiled.get("top"), seconds=seconds)
    if not on_card:
        fail("mesh_files: a solution is not on the card")
    bad = {k: v for k, v in relres.items()
           if not v <= (KRYLOV_RTOL if k in iters else DIRECT_RES)}
    if bad:
        fail(f"mesh_files: relative residuals {bad}")
    if not all(it["converged"] for it in iters.values()):
        fail(f"mesh_files: a Krylov solve did not converge: {iters}")
    if not rate > PLATE_RATE:
        fail(f"mesh_files: the P1 stress error fell {rate}x from the "
             f"quarter to the full size, not more than {PLATE_RATE}x")
    if not norms["k2"] < norms["k1"]:
        fail(f"mesh_files: P2 stress error {norms['k2']} not below P1's "
             f"{norms['k1']}")
    if not iters["k2_asm"]["iters"] <= iters["k2_jacobi"]["iters"]:
        fail(f"mesh_files: asm took more iterations than jacobi: {iters}")
    if not cpu_rel <= PLATE_CPU_REL:
        fail(f"mesh_files: the quarter-size card norm differs from the "
             f"host's by {cpu_rel}")
    if not all(same_M.values()):
        fail(f"mesh_files: M read from the CSV differs from the in-memory "
             f"triples' M: {same_M}")
    if not p2_rel <= P2_SHUFFLE_REL:
        fail(f"mesh_files: the shuffled Exodus P2 system or norms differ "
             f"from the own numbering's by {p2_rel}: {p2}")


N_RANKS = 4                      # the sharded phase's ranks, on one card
N_BG_SHARD3 = 52                 # its 3D hierarchy: 53 → 27 → 14 dense
MAX_SHARDED_ITERS_DIFF = 4       # CG iterations against the single device
VCYCLE_REL = 3e-6                # sharded V-cycle vs single-device, f32
SYSTEM_REL = 1e-10               # ShardedProjectedSystem vs the operator
DEMO_SHARDED_REL = 1e-8          # demo --devices 4 vs its single-device run
REF_SHARDED_DEMO = 4             # the demo's --ref: n_bg = 64
SHARDED_MAIN = ("stencil_mv", "jacobi_smooth", "stencil_mv_block")


def _rel_diff(a, b) -> float:
    import torch

    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def sharded_rank(mesh, p):
    """One rank of the sharded phase: the sharded MG-PCG refinement of the
    2D main path counted (launches by kernel, collectives, seconds, plain
    applies on the card), then the other sharded classes against their
    single-device counterparts on the same card (not counted)."""
    import torch

    from iifea_tpu_torch.mesh.generators import immersed_square_problem
    from iifea_tpu_torch.models.poisson import PoissonProblem
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.ops.projection import assemble_background_system
    from iifea_tpu_torch.parallel.multigrid import (
        ShardedMultigrid2D,
        ShardedMultigrid3D,
        ShardedMultigridBlock2D,
        refine_sharded,
    )
    from iifea_tpu_torch.parallel.sharding import ShardedProjectedSystem
    from iifea_tpu_torch.parallel.stencil import (
        ShardedStencil2D,
        ShardedStencil3D,
        ShardedStencilBlock2D,
    )

    dev = mesh.device
    out = {"rank": mesh.rank, "route": mesh.route, "entered": time.time()}
    torch.cuda.reset_peak_memory_stats(dev)
    plain = Counter()
    with plain_on_card(plain):
        sk.reset_launches()
        c0 = mesh.collectives
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x, relres, iters = refine_sharded(mesh, p["solver"], p["S32"],
                                          p["mg"], p["bound"], p["b64"],
                                          1e-10)
        torch.cuda.synchronize(dev)
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = {k: v for k, v in sk.launches().items() if v}
        out["collectives"] = mesh.collectives - c0
    out.update(relres=relres, iters=iters, plain_applies=dict(plain),
               x_digest=_digest(x), x=x if mesh.rank == 0 else None,
               peak_gib_refine=torch.cuda.max_memory_allocated(dev) / 2**30)

    gen = torch.Generator().manual_seed(12)

    def vec(n, dtype=torch.float32):
        return torch.randn(n, generator=gen, dtype=torch.float64).to(
            dtype=dtype, device=dev)

    S32, mg, S3, mg3, Sb, mgb = (p[k] for k in ("S32", "mg", "S3", "mg3",
                                                "Sb", "mgb"))

    def single(fn, S, r):
        """The single-device fn on the hierarchy's own card (the launching
        process's), brought to this rank's."""
        return fn(r.to(S.device)).to(dev)

    checks = {}
    t0 = time.perf_counter()
    smg = ShardedMultigrid2D(mg, mesh)
    r = vec(S32.n)
    y, y1 = (ShardedStencil2D(S32, mesh, bounds=smg.bounds0).mv(r),
             single(S32.mv, S32, r))
    checks["apply2_bitwise"] = bool(torch.equal(y, y1))
    checks["apply2"] = _rel_diff(y, y1)
    z1 = single(mg.minv, S32, r)
    checks["vcycle2"] = _rel_diff(smg.minv(r), z1)
    checks["vcycle2_levels"] = smg.n_sharded
    # a higher threshold replicates 129² and 65² (fused smoothing calls)
    smg = ShardedMultigrid2D(mg, mesh, min_shard_rows=200)
    checks["vcycle2_replicated"] = _rel_diff(smg.minv(r), z1)
    checks["vcycle2_replicated_levels"] = smg.n_sharded
    r = vec(S3.n)
    y, y1 = ShardedStencil3D(S3, mesh).mv(r), single(S3.mv, S3, r)
    checks["apply3_bitwise"] = bool(torch.equal(y, y1))
    checks["apply3"] = _rel_diff(y, y1)
    smg = ShardedMultigrid3D(mg3, mesh)
    checks["vcycle3"] = _rel_diff(smg.minv(r), single(mg3.minv, S3, r))
    checks["vcycle3_levels"] = smg.n_sharded
    r = vec(Sb.n)
    y, y1 = ShardedStencilBlock2D(Sb, mesh).mv(r), single(Sb.mv, Sb, r)
    checks["apply_block_bitwise"] = bool(torch.equal(y, y1))
    checks["apply_block"] = _rel_diff(y, y1)
    smg = ShardedMultigridBlock2D(mgb, mesh)
    checks["vcycle_block"] = _rel_diff(smg.minv(r), single(mgb.minv, Sb, r))
    checks["vcycle_block_levels"] = smg.n_sharded
    out["checks_seconds"] = time.perf_counter() - t0

    # the cell-sharded system: every rank builds the problem (its form
    # holds local functions, which do not pickle)
    t0 = time.perf_counter()
    fmesh, M = immersed_square_problem(n_fg=fg_of(N_BG), n_bg=N_BG,
                                       device=dev)
    prob = PoissonProblem(fmesh, k=1, sym=True, beta_value=10, device=dev)
    out["system_setup_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    system = ShardedProjectedSystem(prob.form, M, mesh)
    x64, u64 = vec(M.n_bg_dofs, torch.float64), vec(M.n_bg_dofs,
                                                      torch.float64)
    blocks = system.assemble_blocks(torch.zeros_like(x64))
    c0 = mesh.collectives
    got = {"matvec": system.matvec(blocks, x64), "diag": system.diag(blocks),
           "residual": system.residual_b(0.1 * u64)}
    out["system_collectives"] = mesh.collectives - c0
    if mesh.rank == 0:
        A, _ = assemble_background_system(
            prob.form, torch.zeros(prob.space.n_dofs, dtype=torch.float64,
                                   device=dev), M)
        ref = {"matvec": A.mv(x64), "diag": A.diag(),
               "residual": M.rmv(prob.form.residual(M.mv(0.1 * u64)))}
        for k in got:
            checks[f"system_{k}"] = _rel_diff(got[k], ref[k])
    out["system_seconds"] = time.perf_counter() - t0
    out["checks"] = checks
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["left"] = time.time()
    return out


def phase_sharded(backend: str = "gloo"):
    """bench.py --devices 4 on one card: the single-device hierarchy of
    the 2D main path built once, handed to four gloo ranks (CUDA tensors
    by IPC handle), the sharded f32 MG-PCG inside the f64 refinement on
    every rank; gates on the f64 residual, the iterations against the
    single-device solve, the solution on supported dofs, the kernels every
    rank launched and plain applies on the card. Then the 3D, block and
    cell-sharded classes against their single-device counterparts, and
    the demo's --devices 4 against its single-device run. Backend 'nccl'
    puts the ranks on four cards (the hierarchy stays on the first, the
    ranks take their row blocks from it)."""
    import torch

    from iifea_tpu_torch.demos import poisson as demo
    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.parallel import sharding
    from iifea_tpu_torch.solvers import ksp

    # explicit: a rank on another card would read "cuda" as its own
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    _, _, _, solver, _ = build_solver(N_BG, dev)
    b64, K_cell, K_facet = solver.assemble()
    bound = solver.bind(K_cell, K_facet)
    S32 = solver.probe(bound)
    mg = solver.build_mg(S32)
    (x1, rel1, it1), t1 = sync_time(lambda: solver.refine(S32, mg, bound,
                                                          b64, 1e-10))
    _, _, _, solver3, _ = build_solver(N_BG_SHARD3, dev, dim=3)
    S3 = solver3.probe(solver3.bind(*solver3.assemble()[1:]))
    mg3 = solver3.build_mg(S3)
    del solver3
    _, _, A_el, _, _ = build_elasticity(N_BG_EL, dev)
    Sb = ksp._probe_block(A_el, (N_BG_EL + 1,) * 2, 2, 2, torch.float32)
    mgb = multigrid.StencilMultigridBlock(Sb)
    del A_el
    payload = {"solver": solver, "S32": S32, "mg": mg, "bound": bound,
               "b64": b64, "S3": S3, "mg3": mg3, "Sb": Sb, "mgb": mgb}
    setup = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    t0, wall0 = time.perf_counter(), time.time()
    try:
        ranks = sharding.launch(sharded_rank, N_RANKS, backend,
                                args=(payload,), device=dev, timeout=600)
    except RuntimeError as e:
        fail(f"sharded: {e}")
    t_launch = time.perf_counter() - t0
    # from the launch to the last rank's entry, and from its exit to the
    # results' return: spawning, joining the group, the IPC handles
    spawn = max(r["entered"] for r in ranks) - wall0
    teardown = wall0 + t_launch - max(r["left"] for r in ranks)
    diag = S32.diag()
    mask = diag > 0.05 * diag.max()
    scale = max(float(x1.abs().max()), 1.0)
    x0 = ranks[0]["x"].to(dev)
    agree = float((x0 - x1)[mask].abs().max()) / scale
    per_rank = [{k: r[k] for k in ("rank", "iters", "relres", "seconds",
                                   "launches", "collectives",
                                   "plain_applies", "peak_gib_refine",
                                   "peak_gib", "checks_seconds",
                                   "system_setup_seconds", "system_seconds",
                                   "system_collectives") if k in r}
                for r in ranks]
    phase("sharded", backend=backend, route=ranks[0]["route"],
          world_size=N_RANKS, cards=cards,
          ranks_per_card=1 if backend == "nccl" else N_RANKS, n_bg=N_BG,
          n_bg_dofs=int(b64.numel()), setup_seconds=setup,
          launch_seconds=t_launch, spawn_seconds=spawn,
          teardown_seconds=teardown, single_device={
              "iters": it1, "rel_residual": rel1, "seconds": t1},
          sharded_levels=ranks[0]["checks"]["vcycle2_levels"],
          collectives_per_cg_iteration=ranks[0]["collectives"]
          / max(ranks[0]["iters"], 1),
          supported_dofs=int(mask.sum()), agreement=agree, ranks=per_rank,
          checks=[r["checks"] for r in ranks])
    for r in ranks:
        tag = f"sharded: rank {r['rank']}"
        if not r["relres"] < 1e-10:
            fail(f"{tag}: f64 relative residual {r['relres']} >= 1e-10")
        if abs(r["iters"] - it1) > MAX_SHARDED_ITERS_DIFF:
            fail(f"{tag}: {r['iters']} CG iterations against the single "
                 f"device's {it1}")
        if not all(r["launches"].get(k, 0) > 0 for k in SHARDED_MAIN):
            fail(f"{tag}: a kernel of the sharded path did not launch: "
                 f"{r['launches']}")
        if r["plain_applies"].get("elsewhere", 0):
            fail(f"{tag}: {r['plain_applies']} plain stencil applies on "
                 "the card outside the coarse dense inverse")
        if r["x_digest"] != ranks[0]["x_digest"]:
            fail(f"{tag}: its solution differs from rank 0's")
        c = r["checks"]
        for k in ("apply2", "apply3", "apply_block"):
            if not c[k] <= TOL:
                fail(f"{tag}: the sharded {k} differs from the single "
                     f"device's by {c[k]}")
        for k in ("vcycle2", "vcycle2_replicated", "vcycle3",
                  "vcycle_block"):
            if not c[k] <= VCYCLE_REL:
                fail(f"{tag}: the sharded {k} differs from the single "
                     f"device's by {c[k]}")
    for k in ("matvec", "diag", "residual"):
        if not ranks[0]["checks"][f"system_{k}"] <= SYSTEM_REL:
            fail(f"sharded: ShardedProjectedSystem {k} differs by "
                 f"{ranks[0]['checks'][f'system_{k}']}")
    if not agree <= 1e-7:
        fail(f"sharded: the solution differs from the single device's by "
             f"{agree} of max|x| on supported dofs")

    # the demo's SPMD path through its entry point
    argv = ["--ref", str(REF_SHARDED_DEMO), "--device", str(dev)]
    one, t_one = sync_time(lambda: demo.main(argv + ["--solv", "cg"]))
    four, t_four = sync_time(lambda: demo.main(
        argv + ["--devices", str(N_RANKS), "--backend", backend]))
    rel = {k: abs(four["norms"][k] - one["norms"][k]) / one["norms"][k]
           for k in one["norms"]}
    phase("sharded_demo", ref=REF_SHARDED_DEMO, devices=N_RANKS,
          backend=backend,
          route=four["ranks"][0]["route"], single_seconds=t_one,
          sharded_seconds=t_four, single_iters=one["info"].iters,
          sharded_iters=four["info"].iters, norms=four["norms"],
          norms_rel_diff=rel,
          collectives=[r["collectives"] for r in four["ranks"]])
    if not max(rel.values()) <= DEMO_SHARDED_REL:
        fail(f"sharded_demo: norms {four['norms']} against the single "
             f"device's {one['norms']}: {rel}")


# -- f64_routes: every solve_ksp(pc='mg') configuration on the card ----------

# the block instances the f64 and radius-3 routes added, (f64, radius,
# fields), 2D and 3D
NEW_BLOCK = ([(True, r, nf) for r in (1, 2, 3) for nf in (2, 3)]
             + [(False, 3, nf) for nf in (2, 3)])
# those on a 2D full-width path, checked at every level of its cycle
# (513² … 17²): the elasticity's f64 route (2 fields), the Taylor-Green
# cell's (3), the elasticity on the quadratic B-spline net (radius 3, 2
# fields, f64 by default and f32 mixed)
PATH_BLOCK2 = [(True, 2, 2), (True, 2, 3), (True, 3, 2), (False, 3, 2)]
F64_RUNS = {}              # name: an f64 route's run inside another phase
F64_ON = {"on": False}     # whether this run holds the f64_routes phase
# the f64 route's foreground field against the mixed route's, L2 over the
# cell domain relative to the field's: both meet a 1e-10 residual, which
# fixes the field to ~κ·1e-10; the error norms (2D elasticity L2 2.5e-5 of
# the field) are recorded beside it, not gated (at n_bg = 512 they differ
# by 2.6e-4 relative while H10 agrees to 1e-9, on an H100)
F64_FIELD_REL = 1e-7
MAX_ITERS_DIFF_EL = 2      # elasticity: f64 CG iterations over the mixed's
MAX_ITERS_DIFF3 = 4        # 3D Poisson: the same
MAX_ITERS_DIFF_HOST = 2    # card against host on one route
N_BG_14C = 511             # elasticity (k = 2) on a 513² quadratic B-spline net
N_BG_14C_RATE = 127        # its L2 error falls from this size's ...
RATE_14C = 2.0             # ... at more than this rate per halving of h (k = 2)
N_BG_14C_SMALL = 15        # card against host (the host took 116 iterations)
# the 3D counterpart (three fields on the quadratic B-spline box): card
# against host on the 9³ net (one dense level; the host's f64 GMRES took
# 152 iterations, 25 s on an 8-core host), the card alone on the 17³ net
# (the host's 656 iterations took 379 s there)
N_BG_14C3 = (7, 15)
F64_SOAK_ROUNDS = 100


def f64_route(name, tag, solve, A, b, names, *, mixed_iters=None,
              iters_diff=None, max_iters=None, norms=None, gate_rel=True):
    """The f64 route (``mixed=False``) of a system another phase built and
    solved on the card's default (mixed) route: ``solve()`` with every launch
    counter set to 0 just before and read just after (each kernel of
    ``names`` must launch), no plain stencil apply on the card outside the
    coarse dense inverse, converged, with an f64 relative residual below
    1e-10 (``gate_rel``), iterations at most ``iters_diff`` above
    ``mixed_iters`` (the f64 cycle may take fewer: elasticity n_bg=512 28
    against 32, 3D Poisson 36 against 40 on an H100; the residual gate
    holds it to the exact operator) and at most ``max_iters``, and with
    ``norms`` = (error norms of a background vector, the L2 norm of its
    foreground field over the cell domain, the mixed route's solution) the
    foreground field within F64_FIELD_REL of the mixed route's (both error
    norms recorded). Books the run under
    ``name`` (instance ``tag``) for the f64_routes phase and the kernels
    line. Returns (u, info)."""
    import torch

    plain = Counter()
    with plain_on_card(plain):
        (u, info), seconds, _, by_shape = counted_run(solve, names,
                                                      f"f64_routes {name}")
    launched = Counter()
    for k, n in by_shape.items():
        if "_call@" not in k:
            launched[k.split("@")[0]] += n
    rec = {"instance": tag, "iters": int(info.iters),
           "mixed_iters": mixed_iters,
           "converged": bool(info.converged), "seconds": seconds,
           "rel_residual": rel_residual(A, b, u),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": dict(launched), "launches_by_shape": by_shape,
           "plain_applies_on_card": dict(plain)}
    if norms is not None:
        fn, field, u_mixed = norms
        got, ref = fn(u), fn(u_mixed)
        rec.update(error_norms=got, mixed_error_norms=ref,
                   norms_rel_diff={k: abs(got[k] - ref[k]) / ref[k]
                                   for k in ref},
                   field_rel_diff=field(u - u_mixed) / field(u_mixed))
    F64_RUNS[name] = rec
    phase("f64_route", name=name, **rec)
    if not (u.is_cuda and info.converged and bool(torch.isfinite(u).all())):
        fail(f"f64_routes {name}: not a converged finite card solution")
    if gate_rel and not rec["rel_residual"] < 1e-10:
        fail(f"f64_routes {name}: f64 residual {rec['rel_residual']}")
    if iters_diff is not None and not info.iters <= mixed_iters + iters_diff:
        fail(f"f64_routes {name}: {info.iters} iterations against the "
             f"mixed route's {mixed_iters}")
    if max_iters is not None and not info.iters <= max_iters:
        fail(f"f64_routes {name}: {info.iters} iterations > {max_iters}")
    if norms is not None and not rec["field_rel_diff"] <= F64_FIELD_REL:
        fail(f"f64_routes {name}: the field is {rec['field_rel_diff']} from "
             "the mixed route's")
    if plain["elsewhere"]:
        fail(f"f64_routes {name}: {plain['elsewhere']} plain stencil "
             "applies on the card outside the coarse dense inverse")
    return u, info


def field_norms(prob, M, u_mixed):
    """``f64_route``'s ``norms``: the problem's error norms and the L2 norm
    of a background vector's foreground field over its cell domain, and
    the mixed route's solution."""
    from iifea_tpu_torch.api import l2_norm

    n_fields = prob.space.n_fields
    return (lambda v: prob.error_norms(M.mv(v)),
            lambda v: l2_norm(M.mv(v), prob.cell_dom, n_fields), u_mixed)


def block_names(dim, shapes, radius, n_fields, f64):
    """The kernels a block cycle on these smoothed level shapes launches:
    the apply, the fused smoothing call where the plan gives a level one
    launch, the passes where it gives one none."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    dev = torch.cuda.current_device()
    if dim == 2:
        fused = [sk._smooth_route(tuple(sh), radius, n_fields, dev, f64)
                 == sk.GRID for sh in shapes]
        passes, apply, call = ("jacobi_smooth",), "stencil_mv_block", "smooth"
    else:
        fused = [bool(sk._plan3(tuple(sh), radius, n_fields, dev, f64)[1])
                 for sh in shapes]
        passes = ("zero3_block", "sweep3_block", "residual3_block")
        apply, call = "stencil3d_block", "smooth3"
    return ((apply,) + (call,) * any(fused)
            + passes * (not all(fused)))


def kernels_f64(worst, dev):
    """The instances the f64 and radius-3 routes added against their plain
    versions (f32 TOL, f64 TOL64), their compiler reports having been held
    by the kernels phases: 2D blocks (stencil_mv_block, smooth by every
    route) at odd shapes (ν = 1–3, every form) and, on a full-width path,
    at every level shape of its cycle; 3D blocks (stencil3d_block's four
    passes) at odd shapes and at the levels of their cycles (3 × 97³ … 13³
    f64 r = 2; 65³, 33³, 17³ at r = 3), scalar f64 r = 1, 2 planes
    (stencil_mv3, jacobi_smooth3, cheb_step3) at odd shapes and 105³ …
    27³; smooth3 by both routes at those levels (bitwise equal where the
    level call fits); a soak of interleaved launches. Then ``kernel_time``
    rows, with the plain versions' times, of each kernel the full-width
    f64 routes launch, at the shape they run it. Returns the rows."""
    import numpy as np
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    rng = np.random.default_rng(14)
    gen = torch.Generator(device=dev).manual_seed(14)
    f32, f64 = torch.float32, torch.float64
    all_forms = [(z, w) for z in (False, True) for w in (False, True)]
    bitwise = True
    for is64, r, nF in NEW_BLOCK:
        dt = f64 if is64 else f32
        for sh in ODD_SHAPES:
            bitwise &= check_level_entries(worst, rng, sh, r, nF, dev,
                                           (1, 2, 3), all_forms, dt)
        if (is64, r, nF) in PATH_BLOCK2:
            for sh in BLOCK_SMOOTHED:
                bitwise &= check_level_entries(worst, rng, sh, r, nF, dev,
                                               (NU,), list(FORMS.values()),
                                               dt)
        torch.cuda.empty_cache()
    if not bitwise:
        fail("f64_routes: a 2D fused smoothing call differs from its passes")
    for is64, r, nF in NEW_BLOCK:
        dt = f64 if is64 else f32
        for sh in ODD_SHAPES3:
            check_block3(worst, gen, sh, r, nF, dev, dt)
        for sh in (BLOCK3_SMOOTHED if (is64, r, nF) == (True, 2, 3)
                   else LEVELS_BH3 if r == 3 else []):
            check_block3(worst, gen, sh, r, nF, dev, dt)
            torch.cuda.empty_cache()
    for r in (1, 2):
        for sh in ODD_SHAPES3 + (LEVELS3 if r == 2 else []):
            check_block3(worst, gen, sh, r, 0, dev, f64)
            C, invd, b, x = scalar3_operands(gen, sh, r, f64, dev)
            d = torch.randn(b.shape, generator=gen, device=dev, dtype=f64)
            _check(worst, "stencil_mv3", sk.stencil_mv3(C, x, sh, r),
                   sk.stencil_mv3_plain(C, x, sh, r), sh, r, quiet=True)
            _check(worst, "jacobi_smooth3",
                   sk.jacobi_smooth3(C, invd, b, x, 0.67, sh, r),
                   sk.jacobi_smooth3_plain(C, invd, b, x, 0.67, sh, r), sh,
                   r, quiet=True)
            for beta in (0.0, 0.45):
                y, dy = sk.cheb_step3(C, invd, b, x, None if beta == 0
                                      else d.clone(), 1.3, beta, sh, r)
                ry, rd = sk.cheb_step3_plain(C, invd, b, x, None if beta == 0
                                             else d, 1.3, beta, sh, r)
                _check(worst, "cheb_step3", y, ry, sh, r, quiet=True)
                _check(worst, "cheb_step3", dy, rd, sh, r, quiet=True)
            del C, invd, b, x, d
        torch.cuda.empty_cache()
    paths = [("elasticity3_f64", N_FIELDS_EL3, 2, f64, False,
              BLOCK3_SMOOTHED, "fused"),
             ("poisson3_f64", 0, 2, f64, True, LEVELS3, "fused")]
    rows = kernels3_smooth(worst, dev, paths)
    checks = [(f"bspline_el3_{'f64' if is64 else 'f32'}_nf{nF}", nF, 3,
               f64 if is64 else f32, False, LEVELS_BH3, None)
              for is64, r, nF in NEW_BLOCK if r == 3]
    kernels3_smooth(worst, dev, checks, timed=False)
    phase("kernel_check", kernel="f64 and radius-3 instances",
          worst={k: v for k, v in worst.items()
                 if "/f64" in k or "/nf2" in k or "/r3/nf3" in k})

    # soak: the new instances at their paths' shapes, interleaved, never
    # synchronised until the end; every repeat equals its first result
    ops = []
    for is64, r, nF in PATH_BLOCK2:
        C, binv, b, x = level_operands(rng, BLOCK_SMOOTHED[2], r, nF, dev,
                                       f64 if is64 else f32)
        ops.append(partial(sk.stencil_mv_block, C, x, BLOCK_SMOOTHED[2], r))
        ops.append(partial(lambda *a: torch.cat(sk.smooth(*a, True)), C,
                           binv, b, None, 1.0, NU, BLOCK_SMOOTHED[2], r))
    for sh, r, nF in ((BLOCK3_SMOOTHED[1], 2, N_FIELDS_EL3),
                      (LEVELS_BH3[-1], 3, N_FIELDS_EL3)):
        C, binv, b, x = block3_operands(gen, sh, r, nF, dev, f64)
        ops += list(block3_calls(C, binv, b, x, sh, r).values())
        ops.append(partial(lambda *a: torch.cat(sk.smooth3(*a, True)), C,
                           binv, b, None, [(1.0, 0.0)] * NU, sh, r))
    C, invd, b, x = scalar3_operands(gen, LEVELS3[1], 2, f64, dev)
    ops.append(partial(sk.cheb_step3, C, invd, b, x, None, 1.3, 0.0,
                       LEVELS3[1], 2))
    first = [fn() for fn in ops]
    first = [v[0] if isinstance(v, tuple) else v for v in first]
    mismatches = torch.zeros((), dtype=torch.int64, device=dev)
    before = sum(sk.launches().values())
    t0 = time.perf_counter()
    for _ in range(F64_SOAK_ROUNDS):
        for fn, ref in zip(ops, first):
            v = fn()
            mismatches += ((v[0] if isinstance(v, tuple) else v)
                           != ref).sum()
    torch.cuda.synchronize()
    phase("soak", kernel="f64 and radius-3 instances",
          launches=sum(sk.launches().values()) - before,
          seconds=time.perf_counter() - t0, mismatches=int(mismatches))
    if int(mismatches):
        fail(f"f64_routes soak: {int(mismatches)} values differ between "
             "repeats")
    del ops, first
    torch.cuda.empty_cache()

    # the summary's rows: each kernel of a full-width route at its shape
    for is64, r, nF in PATH_BLOCK2:
        dt = f64 if is64 else f32
        fused = [sh for sh in BLOCK_SMOOTHED
                 if sk._smooth_route(sh, r, nF, 0, is64) == sk.GRID]
        rows += time_level(rng, BLOCK_SMOOTHED[0], nF, dev, main_block=True,
                           main_smooth=False, radius=r, dtype=dt)
        if fused:
            rows += time_level(rng, fused[0], nF, dev, main_block=False,
                               main_smooth=True, radius=r, dtype=dt)
        torch.cuda.empty_cache()
    for sh, r in ((BLOCK3_SMOOTHED[0], 2), (LEVELS_BH3[-1], 3)):
        C, binv, b, x = block3_operands(gen, sh, r, N_FIELDS_EL3, dev, f64)
        calls = block3_calls(C, binv, b, x, sh, r, omega=1.0)
        plain = block3_calls(C, binv, b, x, sh, r, omega=1.0, plain=True)
        held = []
        for mode in BLOCK3_MODES:
            rows.append(time_kernel(
                sk.PASS3_NAMES[mode, True], [N_FIELDS_EL3, *sh],
                calls[mode], plain[mode],
                bound_=bound_passes(sh, N_FIELDS_EL3, [mode], r, True),
                plain_launches=2, radius=r, f64=True, n_fields=N_FIELDS_EL3,
                dim=3, library=block3_library(C, b, x, sh, r, mode, held)))
        del C, binv, b, x, calls, plain, held
        torch.cuda.empty_cache()
    rows += kernels3_smooth(worst, dev, [
        ("bspline_el3_f64", N_FIELDS_EL3, 3, f64, False, [LEVELS_BH3[-1]],
         "fused")])
    C, invd, b, x = scalar3_operands(gen, SHAPE3, 2, f64, dev)
    d = torch.randn(b.shape, generator=gen, device=dev, dtype=f64)
    rows.append(time_kernel(
        "stencil_mv3", SHAPE3, partial(sk.stencil_mv3, C, x, SHAPE3, 2),
        partial(sk.stencil_mv3_plain, C, x, SHAPE3, 2), plain_launches=2,
        f64=True, library=csr_call(C, SHAPE3, 2, x)))
    rows.append(time_kernel(
        "cheb_step3", SHAPE3,
        partial(sk.cheb_step3, C, invd, b, x, d, 1.3, 0.45, SHAPE3, 2),
        partial(sk.cheb_step3_plain, C, invd, b, x, d, 1.3, 0.45, SHAPE3, 2),
        plain_launches=2, f64=True))
    del C, invd, b, x, d
    torch.cuda.empty_cache()
    return rows


def bspline_elasticity(n_bg: int, device, dim: int = 2, bg_degree: int = 2,
                       n_fg: int | None = None):
    """Vector elasticity (k = 2) on the quadratic B-spline background
    (``bg_degree`` 3: the cubic one):
    ``immersed_square_bspline_problem(n_fg=2·n_bg, n_bg, n_fields=2)`` or
    its cube (three fields), ImmersedElasticityProblem(k=2), assembled at
    u = 0 (``n_fg`` another multiple of n_bg). Returns (prob, M, lattice
    shape, A, b, set-up seconds)."""
    import torch

    from iifea_tpu_torch.mesh import generators
    from iifea_tpu_torch.models.elasticity import ImmersedElasticityProblem
    from iifea_tpu_torch.ops.projection import assemble_background_system

    t0 = time.perf_counter()
    gen = (generators.immersed_square_bspline_problem if dim == 2
           else generators.immersed_cube_bspline_problem)
    mesh, M, shape = gen(n_fg=n_fg or 2 * n_bg, n_bg=n_bg,
                         bg_degree=bg_degree, n_fields=dim, device=device)
    prob = ImmersedElasticityProblem(mesh, k=2, device=device)
    u0 = torch.zeros(prob.space.n_dofs, dtype=torch.float64, device=device)
    A, b = assemble_background_system(prob.form, u0, M)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return prob, M, tuple(shape), A, b, time.perf_counter() - t0


def bspline_el_solve(A, b, shape, dim: int = 2, radius: int = 3, **kw):
    from iifea_tpu_torch.solvers import ksp

    return ksp.solve_ksp(A, b, method="gmres", pc="mg", rtol=1e-10,
                         lattice_shape=shape, stencil_radius=radius,
                         n_fields=dim, monitor=False, **kw)


def card_against_host(tag, build, solve, field_rel=F64_FIELD_REL,
                      iters_diff=MAX_ITERS_DIFF_HOST):
    """One system built (``build(device)`` = (A, b, (prob, M) or None)) and
    solved (``solve(A, b)``) on the card and on the host: both converged,
    the same iterations within ``iters_diff`` and, where the problem
    is given, the card's foreground field within ``field_rel`` of the
    host's (L2 over the host's cell domain; the error norms recorded).
    Prints and returns the phase line's fields."""
    from iifea_tpu_torch.api import l2_norm

    out = {}
    for dev in ("cuda", "cpu"):
        A, b, pm = build(dev)
        (u, info), dt = sync_time(lambda: solve(A, b))
        out[dev] = ({"iters": int(info.iters), "converged": bool(
            info.converged), "on_card": u.is_cuda, "seconds": dt,
            "rel_residual": rel_residual(A, b, u),
            "error_norms": None if pm is None
            else pm[0].error_norms(pm[1].mv(u))}, u.cpu(), pm)
    (card, u_c, _), (host, u_h, pm) = out["cuda"], out["cpu"]
    row = {"card": card, "host": host}
    if pm is not None:
        prob, M = pm

        def field(v):
            return l2_norm(M.mv(v), prob.cell_dom, prob.space.n_fields)

        row.update(field_rel_diff=field(u_c - u_h) / field(u_h),
                   norms_rel_diff={
                       k: abs(v - host["error_norms"][k])
                       / host["error_norms"][k]
                       for k, v in card["error_norms"].items()})
    phase(tag, **row)
    if not (card["on_card"] and card["converged"] and host["converged"]):
        fail(f"{tag}: not converged on the card or the host: {row}")
    if not abs(card["iters"] - host["iters"]) <= iters_diff:
        fail(f"{tag}: {card['iters']} iterations on the card, "
             f"{host['iters']} on the host")
    if pm is not None and not row["field_rel_diff"] <= field_rel:
        fail(f"{tag}: the card's field is {row['field_rel_diff']} from the "
             "host's")
    return row


def phase_f64_routes():
    """Every solve_ksp(pc='mg') configuration of the JAX package on the
    card's hand kernels (dimension 2|3, 1–3 fields, radius 1–3, f32|f64):
    the new instances against their plain versions (``kernels_f64``); the
    Taylor-Green small reference (ref 2, unpinned) first system on the f64
    route, card against host; radius 3 with two fields (ROADMAP 14c):
    elasticity (k = 2) on the quadratic B-spline net at n_bg = 15 card
    against host, at n_bg = 511 (2 × 513² dofs) on the f64 default and the
    f32 mixed route, counted, both below 1e-10, its L2 error falling from
    n_bg = 127's at a rate above RATE_14C per halving; its 3D counterpart
    (three fields) card against host on the 9³ net, and on the 17³ net
    below 1e-10 with its L2 error below the 9³ net's. The
    full-width f64 routes of the 3D elasticity (n_bg = 96), the 2D
    elasticity (n_bg = 512), the Taylor-Green cell's first system (ref 7)
    and the 3D Poisson front-end (n_bg = 104) run inside their own phases
    on those phases' systems (``f64_route``) and are summed up here.
    Returns (worst errors, kernel_time rows, {instance tag: (launches by
    kernel, by shape)})."""
    import math

    import torch

    from iifea_tpu_torch.solvers import ksp

    dev = torch.device("cuda", 0)
    worst = {}
    rows = kernels_f64(worst, dev)

    # the Taylor-Green small reference's first system on the f64 route
    def tg_build(device):
        prob, M, up_p, up_f, pin, shape, t = tg_cell(device, NS_SMALL,
                                                     pinned=False)
        A, b, _, _ = tg_first_system(prob, M, up_p, up_f, pin, t)
        return A, b, None

    card_against_host(
        "f64_routes_taylor_green_small", tg_build,
        lambda A, b: ksp.solve_ksp(
            A, b, method="gmres", pc="mg", rtol=1e-8, atol=1e-9,
            lattice_shape=(17, 17), n_fields=3, monitor=False, mixed=False))

    # radius 3 with several fields: elasticity on the B-spline net
    def bs_build(n_bg, dim):
        def build(device):
            prob, M, _, A, b, _ = bspline_elasticity(n_bg, device, dim)
            return A, b, (prob, M)
        return build

    shape_small = (N_BG_14C_SMALL + 2,) * 2
    card_against_host("f64_routes_bspline_elasticity_small",
                      bs_build(N_BG_14C_SMALL, 2),
                      lambda A, b: bspline_el_solve(A, b, shape_small))
    small3, full3 = N_BG_14C3
    row3 = card_against_host(
        "f64_routes_bspline_elasticity3_small", bs_build(small3, 3),
        lambda A, b: bspline_el_solve(A, b, (small3 + 2,) * 3, 3))
    p3, M3, sh3, A3, b3, setup3 = bspline_elasticity(full3, "cuda", 3)
    (u3, info3), t3 = sync_time(lambda: bspline_el_solve(A3, b3, sh3, 3))
    n3 = p3.error_norms(M3.mv(u3))
    relres3 = rel_residual(A3, b3, u3)
    phase("f64_routes_bspline_elasticity3", n_bg=full3,
          n_bg_dofs=M3.n_bg_dofs, setup_seconds=setup3, seconds=t3,
          iters=int(info3.iters), rel_residual=relres3, error_norms=n3,
          error_norms_small=row3["card"]["error_norms"])
    if not (u3.is_cuda and relres3 < 1e-10 and n3["L2"]
            < row3["card"]["error_norms"]["L2"]):
        fail(f"f64_routes: 3D B-spline elasticity n_bg={full3}: residual "
             f"{relres3}, norms {n3}")
    del p3, M3, A3, b3, u3

    p127, M127, sh127, A127, b127, _ = bspline_elasticity(N_BG_14C_RATE,
                                                          "cuda")
    u127, info127 = bspline_el_solve(A127, b127, sh127)
    n127 = p127.error_norms(M127.mv(u127))
    del p127, M127, A127, b127, u127
    torch.cuda.empty_cache()
    prob, M, shape, A, b, setup = bspline_elasticity(N_BG_14C, "cuda")
    out = {}
    for name, is64 in (("bspline_elasticity", True),
                       ("bspline_elasticity_mixed", False)):
        u, info = f64_route(
            name, instance_tag(3, is64, 2),
            lambda: bspline_el_solve(A, b, shape, mixed=not is64), A, b,
            block_names(2, BLOCK_SMOOTHED, 3, 2, is64))
        out[name] = (prob.error_norms(M.mv(u)), int(info.iters))
    norms, iters = out["bspline_elasticity"]
    rate = math.log2(n127["L2"] / norms["L2"]) / math.log2(
        N_BG_14C / N_BG_14C_RATE)
    phase("f64_routes_bspline_elasticity", n_bg=N_BG_14C,
          n_bg_dofs=M.n_bg_dofs, lattice=list(shape), setup_seconds=setup,
          iters=iters, mixed_iters=out["bspline_elasticity_mixed"][1],
          error_norms=norms,
          mixed_error_norms=out["bspline_elasticity_mixed"][0],
          error_norms_n_bg127=n127, iters_n_bg127=int(info127.iters),
          l2_rate_per_halving=rate)
    if not all(0 < v < n127[k] for k, v in norms.items()):
        fail(f"f64_routes: B-spline elasticity norms {norms} not below "
             f"n_bg={N_BG_14C_RATE}'s {n127}")
    if not rate > RATE_14C:
        fail(f"f64_routes: B-spline elasticity L2 rate {rate} <= "
             f"{RATE_14C}")
    del prob, M, A, b
    torch.cuda.empty_cache()

    want = ("elasticity", "elasticity3", "front_end3", "taylor_green")
    phase("f64_routes", runs={k: {f: v[f] for f in (
        "instance", "iters", "mixed_iters", "rel_residual", "seconds",
        "launches")} for k, v in F64_RUNS.items()},
        missing=[k for k in want if k not in F64_RUNS])
    by_tag = {}
    for rec in F64_RUNS.values():
        counts, shapes = by_tag.setdefault(rec["instance"], (Counter(),
                                                              Counter()))
        counts.update(rec["launches"])
        shapes.update(rec["launches_by_shape"])
    return worst, rows, by_tag


# -- cubic: radius 4, the cubic B-spline background ------------------------

N_BG_CUBIC = 510           # 2⁹ − 3 + 1 spans: a 513² cubic net, 263,169 dofs
N_BG_CUBIC_RATE = 254      # a 257² net, whose L2_rel the 513²'s must be below
N_BG_CUBIC_SMALL = 14      # a 17² net: card against host
MAX_GMRES_ITERS_CUBIC = 100
N_BG_CUBIC3 = 30           # a 33³ cubic net (35,937 dofs; n_fg = 60)
N_BG_CUBIC3_SMALL = 6      # a 9³ net: card against host
# The 3D cycles (the JAX package's) are weak at radius 4: on an H100 the
# biharmonic's f64 route took 30,084 GMRES iterations (93.6 s) to 1e-10 at
# 33³ and stalled at 1.4e-9 after 15,000 at 17³, its f32 mixed route at
# 1.4e-9 after 3,372 at 33³; the three-field elasticity took 55,744 to 1e-10
# on the 9³ net (one dense level; tests/compare_cubic3.py --iters 14,30).
# The JAX package's own MG-GMRES takes 98 iterations on the 9³ net (the
# port 104), and the two solutions at 1e-10 lie 6e-3 apart (max-abs) with
# norms 7e-6 apart (tests/compare_cubic3_jax.py on a CPU, held by
# tests/test_torch_cubic3d.py): the cycle and the loosely fixed solution
# are the reference algorithm's at r = 4. The script runs each 3D solve to
# CUBIC3_MAX_IT iterations and holds the residual reached below
# CUBIC3_MAX_REL (1.2e-9, 1.4e-9, 2.2e-10, 3.2e-10 measured), the
# biharmonic's L2 error below the 9³ net's. The biharmonic's f64 route is
# capped at CUBIC3_MAX_IT; the elasticity, whose residual falls below 1e-9
# in four restart cycles, at CUBIC_EL3_MAX_IT; the mixed route, the route
# not taken, at OTHER_ROUTE_MAX_IT with its outcome recorded.
CUBIC3_MAX_IT = 3000
CUBIC_EL3_MAX_IT = 900
CUBIC3_MAX_REL = 1e-8
CUBIC_HOST_REL = 1e-8      # the card's error norms against the host's
# ... on the 9³ net, one dense level: its soft-truncated pseudo-inverse
# leaves near-null modes half inverted, where the card's and the host's
# roundings part (on an H100 the same 104 iterations, the field 5.8e-7
# apart, the norms 1.1e-7): field and norms are held to 1e-5 and 1e-6
CUBIC3_HOST_FIELD_REL = 1e-5
CUBIC3_HOST_REL = 1e-6
# the three-field 3D cubic elasticity's foreground field against host
# SuperLU's on the 9³ net: its single dense level leaves the residual
# fixing the field only to ~1e-4 (on an H100 1.15e-4 from LU at 1e-10 after
# 55,744 GMRES iterations, 1.46e-4 at 2.2e-10 after 3,300)
CUBIC_EL3_LU_FIELD_REL = 1e-3


def cubic_counted(tag, solve, A, b, names, iter_cap=None, gate=True):
    """One counted solve of a cubic path (``counted_run``: each kernel of
    ``names`` launched) with no plain stencil apply on the card outside
    the coarse dense inverse; with ``gate`` converged to an f64 relative
    residual below 1e-10 within ``iter_cap`` iterations. Returns (u, info,
    record)."""
    import torch

    plain = Counter()
    with plain_on_card(plain):
        (u, info), seconds, launches, by_shape = counted_run(solve, names,
                                                             tag)
    rec = {"iters": int(info.iters), "seconds": seconds,
           "rel_residual": rel_residual(A, b, u),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "launches_by_shape": by_shape,
           "plain_applies_on_card": dict(plain)}
    if not (u.is_cuda and bool(torch.isfinite(u).all())):
        fail(f"{tag}: not a finite card solution")
    if plain["elsewhere"]:
        fail(f"{tag}: {plain['elsewhere']} plain stencil applies on the card "
             "outside the coarse dense inverse")
    if gate and not rec["rel_residual"] < 1e-10:
        fail(f"{tag}: f64 relative residual {rec['rel_residual']}")
    if gate and iter_cap is not None and not info.iters <= iter_cap:
        fail(f"{tag}: {info.iters} iterations > {iter_cap}")
    return u, info, rec


def ring_share(C, radius: int) -> float:
    """The largest |coefficient| on the stencil's outer ring (an offset of
    ``radius`` along some axis) over the largest |coefficient|."""
    import torch

    m = 2 * radius + 1
    dim = C.dim() - 1
    taps = C.reshape(*(m,) * dim, -1).abs().amax(dim=-1)
    inner = torch.zeros_like(taps, dtype=torch.bool)
    inner[(slice(1, m - 1),) * dim] = True
    return float(taps[~inner].amax() / taps.amax())


def phase_cubic():
    """Radius 4, the cubic B-spline background, on the card's r = 4
    instances. 2D: the biharmonic on the 513² cubic net (n_bg = 510,
    ``solve_ksp(gmres, pc='mg', stencil_radius=4)``, the f64 default route)
    with host set-up and assembly per stage, counted per kernel and shape,
    a warm solve staged (probe, hierarchy, Krylov), profiled (idle share),
    peak memory, the outer ring's share of its planes; converged below
    1e-10 in at most MAX_GMRES_ITERS_CUBIC iterations with its L2_rel below
    n_bg = 254's; card against host at n_bg = 14 (iterations within 2,
    norms within CUBIC_HOST_REL). Elasticity (k = 2, two fields) on the
    same net by the f64 default and the f32 mixed route, counted, both
    below 1e-10, the foreground field within F64_FIELD_REL between them.
    3D: the biharmonic card against host on the 9³ cubic net (one dense
    level: field and norms within CUBIC3_HOST_FIELD_REL, CUBIC3_HOST_REL),
    then on the 33³ net (n_bg = 30) by both routes, counted (the f32 mixed
    route, the route not taken, capped at OTHER_ROUTE_MAX_IT with its
    outcome recorded: the only full-width run of the f32 r = 4 3D
    instances);
    the three-field elasticity on the 9³ net against host SuperLU (field
    within CUBIC_EL3_LU_FIELD_REL) and on the 17³ net, counted. The 3D
    solves are capped (CUBIC3_MAX_IT, CUBIC_EL3_MAX_IT) and their
    residuals held below CUBIC3_MAX_REL (the biharmonic's L2 error below
    the 9³ net's). Returns {instance tag: (launches by kernel, by shape)}."""
    import torch

    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.solvers import ksp

    gpu = torch.device("cuda", 0)
    seconds = {}
    booked = {}

    def book(tag, rec):
        counts, shapes = booked.setdefault(tag, (Counter(), Counter()))
        counts.update(rec["launches"])
        shapes.update(rec["launches_by_shape"])

    # 2D biharmonic: the rate's reference, then the full width
    t0 = time.perf_counter()
    p, M_, sh_, A_, b_, _ = build_biharmonic(N_BG_CUBIC_RATE, gpu, 3)
    u_, info_ = bh_solve(A_, b_, sh_, radius=4)
    n_rate = p.error_norms(M_.mv(u_))
    del p, M_, A_, b_, u_
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, shape, A, b, setup = build_biharmonic(N_BG_CUBIC, gpu, 3)
    phase("cubic_setup", n_bg=N_BG_CUBIC, n_fg=2 * N_BG_CUBIC,
          lattice=list(shape), n_bg_dofs=M.n_bg_dofs,
          n_fg_nodes=prob.space.n_nodes, n_block_cells=prob.cell_dom.n_elem,
          extraction_entries=M.valT.numel(), seconds=setup,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    names2 = ("stencil_mv", "jacobi_smooth", "stencil_mv_block", "smooth")
    tag = instance_tag(4, True)
    u, info, rec = cubic_counted("cubic", lambda: bh_solve(A, b, shape,
                                                           radius=4),
                                 A, b, names2, MAX_GMRES_ITERS_CUBIC)
    book(tag, rec)
    norms = prob.error_norms(M.mv(u))
    missing = [s_ for s_ in LEVELS_BH if not any(
        rec["launches_by_shape"].get(f"{k}@{s_[0]}x{s_[1]}{tag}", 0) > 0
        for k in names2)]
    stages = Counter()
    with timed_calls([(ksp, "_probe_general"),
                      (multigrid, "StencilMultigrid")], stages):
        (_, info_w), t_w = sync_time(lambda: bh_solve(A, b, shape, radius=4))
    warm = {"solve_ksp": t_w, "probe": stages["_probe_general"],
            "hierarchy": stages["StencilMultigrid"],
            "krylov": t_w - sum(stages.values()), "iters": info_w.iters}
    profile = profile_stats(lambda: bh_solve(A, b, shape, radius=4))
    S = ksp._probe_general(A, shape, 4, torch.float64)
    ring = ring_share(S.coeffs, 4)
    del S
    phase("cubic", n_bg=N_BG_CUBIC, route="f64", error_norms=norms,
          error_norms_n_bg254=n_rate, iters_n_bg254=int(info_.iters),
          stages=warm, profile=profile, outer_ring_share=ring, **rec)
    if missing:
        fail(f"cubic: no stencil launch at the smoothed shapes {missing}")
    if not norms["L2_rel"] < n_rate["L2_rel"]:
        fail(f"cubic: L2_rel {norms['L2_rel']} not below n_bg="
             f"{N_BG_CUBIC_RATE}'s {n_rate['L2_rel']}")
    del prob, M, A, b, u
    torch.cuda.empty_cache()
    seconds["biharmonic"] = time.perf_counter() - t0

    def bh_build(n_bg, dim):
        def build(device):
            if dim == 2:
                prob, M, _, A, b, _ = build_biharmonic(n_bg, device, 3)
            else:
                prob, M, _, A, b, _, _ = build_biharmonic3(n_bg, device, 3)
            return A, b, (prob, M)
        return build

    def near_host(tag, row, rel=CUBIC_HOST_REL):
        worst_rel = max(row["norms_rel_diff"].values())
        if not worst_rel <= rel:
            fail(f"{tag}: the card's norms are {worst_rel} from the host's")

    t0 = time.perf_counter()
    small = (N_BG_CUBIC_SMALL + 3,) * 2
    near_host("cubic_small", card_against_host(
        "cubic_small", bh_build(N_BG_CUBIC_SMALL, 2),
        lambda A, b: bh_solve(A, b, small, radius=4)))
    seconds["biharmonic_small"] = time.perf_counter() - t0

    # two fields: elasticity on the 513² cubic net, both routes
    t0 = time.perf_counter()
    prob, M, shape, A, b, setup = bspline_elasticity(N_BG_CUBIC, "cuda", 2, 3)
    sols = {}
    for name, is64 in (("cubic_elasticity", True),
                       ("cubic_elasticity_mixed", False)):
        u, info, rec = cubic_counted(
            name, lambda: bspline_el_solve(A, b, shape, radius=4,
                                           mixed=not is64),
            A, b, block_names(2, BLOCK_SMOOTHED, 4, 2, is64))
        book(instance_tag(4, is64, 2), rec)
        sols[name] = u
        phase(name, n_bg=N_BG_CUBIC, n_bg_dofs=M.n_bg_dofs,
              setup_seconds=setup, error_norms=prob.error_norms(M.mv(u)),
              **rec)
    norms_f = field_norms(prob, M, sols["cubic_elasticity"])
    field_rel = (norms_f[1](sols["cubic_elasticity_mixed"]
                            - sols["cubic_elasticity"])
                 / norms_f[1](sols["cubic_elasticity"]))
    phase("cubic_elasticity_routes", field_rel_diff=field_rel)
    if not field_rel <= F64_FIELD_REL:
        fail(f"cubic elasticity: the routes' fields are {field_rel} apart")
    del prob, M, A, b, sols
    torch.cuda.empty_cache()
    seconds["elasticity"] = time.perf_counter() - t0

    # 3D: the biharmonic on the 9³ cubic net card against host, then on
    # the 33³ net by both routes, each capped
    t0 = time.perf_counter()
    small3 = (N_BG_CUBIC3_SMALL + 3,) * 3
    row3 = card_against_host(
        "cubic3_small", bh_build(N_BG_CUBIC3_SMALL, 3),
        lambda A, b: bh_solve(A, b, small3, radius=4), CUBIC3_HOST_FIELD_REL)
    near_host("cubic3_small", row3, CUBIC3_HOST_REL)
    prob, M, shape, A, b, setup3, mem = build_biharmonic3(N_BG_CUBIC3, gpu, 3)
    phase("cubic3_setup", n_bg=N_BG_CUBIC3, lattice=list(shape),
          n_bg_dofs=M.n_bg_dofs, n_fg_nodes=prob.space.n_nodes,
          extraction_entries=M.valT.numel(), seconds=setup3, **mem)
    for name, is64 in (("cubic3", True), ("cubic3_mixed", False)):
        u, info, rec = cubic_counted(
            name, lambda: bh_solve(A, b, shape, radius=4, mixed=not is64,
                                   max_it=CUBIC3_MAX_IT if is64
                                   else OTHER_ROUTE_MAX_IT),
            A, b, names3(LEVELS_CUBIC3, 4, is64), gate=False)
        book(instance_tag(4, is64), rec)
        norms3 = prob.error_norms(M.mv(u))
        phase(name, n_bg=N_BG_CUBIC3, error_norms=norms3,
              converged=rec["rel_residual"] < 1e-10, **rec)
        if is64 and not (rec["rel_residual"] < CUBIC3_MAX_REL
                         and norms3["L2_rel"]
                         < row3["card"]["error_norms"]["L2_rel"]):
            fail(f"{name}: residual {rec['rel_residual']} after "
                 f"{info.iters} iterations, norms {norms3}")
    del prob, M, A, b, u
    torch.cuda.empty_cache()
    seconds["biharmonic3"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # three fields: elasticity on the 9³ net (one dense level) against
    # host SuperLU on the same system (the host's own MG-GMRES takes minutes
    # there: a 2,187-column probe and a 6,561-slice plain apply an
    # iteration), then on the 17³ net, each capped at CUBIC3_MAX_IT
    for n_bg in (N_BG_CUBIC3_SMALL, N_BG_CUBIC_SMALL):
        prob, M, shape, A, b, setup = bspline_elasticity(n_bg, "cuda", 3, 3)
        name = ("cubic_elasticity3_small" if n_bg == N_BG_CUBIC3_SMALL
                else "cubic_elasticity3")
        u, info, rec = cubic_counted(
            name, lambda: bspline_el_solve(A, b, shape, 3, radius=4,
                                           max_it=CUBIC_EL3_MAX_IT),
            A, b, block_names(3, [shape] if n_bg == N_BG_CUBIC_SMALL else [],
                              4, N_FIELDS_EL3, True), gate=False)
        row = {"error_norms": prob.error_norms(M.mv(u))}
        if n_bg == N_BG_CUBIC3_SMALL:
            u_lu, _ = ksp.solve_ksp(A, b, method="direct", monitor=False)
            field = field_norms(prob, M, u_lu)[1]
            row.update(error_norms_lu=prob.error_norms(M.mv(u_lu)),
                       field_rel_diff=field(u - u_lu) / field(u_lu))
        else:
            book(instance_tag(4, True, N_FIELDS_EL3), rec)
        phase(name, n_bg=n_bg, n_bg_dofs=M.n_bg_dofs, setup_seconds=setup,
              converged=rec["rel_residual"] < 1e-10, **row, **rec)
        if not (rec["rel_residual"] < CUBIC3_MAX_REL
                and row.get("field_rel_diff", 0.0) <= CUBIC_EL3_LU_FIELD_REL):
            fail(f"{name}: residual {rec['rel_residual']} after "
                 f"{info.iters} iterations, {row}")
        del prob, M, A, b, u
        torch.cuda.empty_cache()
    seconds["elasticity3"] = time.perf_counter() - t0
    phase("cubic_seconds", **seconds)
    return booked


N_BG_QUARTIC = 509         # 2⁹ − 4 + 1 spans: a 513² quartic net, 263,169 dofs
N_BG_QUARTIC_RATE = 253    # a 257² net, whose L2_rel the 513²'s must be below
N_BG_QUARTIC_SMALL = 13    # a 17² net: card against host
# The 2D quartic cycle is weak too: on an H100 the 513² net took 900 GMRES
# iterations to 1e-10 (three restart cycles); the JAX package's own cycle,
# run on the CPU on the same planes, takes 15 / 20 / 160 / 205 iterations on
# the 17² / 33² / 65² / 129² nets, the port 16 / 20 / 160 / 208 (its count
# rounded up to its check granularity of 4; tests/compare_quartic_jax.py).
# The bound, twice the 900 measured, catches a cycle that stops
# contracting
MAX_GMRES_ITERS_QUARTIC = 1800
# the 513² solve's count on an H100 by one launch a pass (PRs 16-18): a
# level's one launch is bitwise the same arithmetic, so the count may not
# move
QUARTIC_GMRES_ITERS = 900
# a 9³ net: card against host, capped (one dense level; at 17³ the host's
# plain r = 5 passes and 1,331-column probe took 133 s of a 139 s check on
# the card's machine, for 60 GMRES iterations, the card 1.6 s)
N_BG_QUARTIC3_SMALL = 5
N_BG_QUARTIC3 = 29         # a 33³ quartic net (35,937 dofs; n_fg = 58)
# The 17² net's single dense level leaves a 1e-10 residual fixing the
# solution only to ~5e-2 in L2_rel (16 iterations on the host; 36 reach
# 1e-12, within 1.1e-6 of host SuperLU: tests/test_torch_quartic.py), so
# card and host are held to each other at 1e-12. There the roundings part
# the two GMRES runs by a check of 4 iterations (on an H100 32 against the
# host's 36) and their fields by 2.3e-10 (L2 over the cell domain), which
# the error norms, 1.9e-4 of the solution, show as 1.2e-6: iterations are
# held within 4, the field within 1e-8, the norms within 1e-5
QUARTIC_SMALL_RTOL = 1e-12
QUARTIC_SMALL_ITERS_DIFF = 4
QUARTIC_SMALL_FIELD_REL = 1e-8
QUARTIC_SMALL_NORMS_REL = 1e-5
# the 9³ net's 3D cycle at r = 5 (the JAX package's, R11; the host's: a
# relative residual of 4e-5 after 724 iterations): both sides run two
# GMRES(20) cycles (max_it 20: GMRES stops after max_it // restart + 1
# cycles), and the card's relative residual and field are held to the
# host's
QUARTIC3_SMALL_RESTART = 20
QUARTIC3_SMALL_MAX_IT = 20
QUARTIC3_SMALL_REL = 1e-5
# the 33³ f64 solve's cap: on an H100 it stood at 4.9e-9 after 3,300
# iterations (the cubic 3D cap) and falls by a factor ~1.5 a thousand
QUARTIC3_MAX_IT = 1000
# the 3D quartic cycle does not converge in useful time: on the host the
# 9³ net's single dense level leaves a relative residual of 4e-5 after 724
# GMRES iterations; the 33³ solves are capped (the f64 route at
# QUARTIC3_MAX_IT, the mixed one at OTHER_ROUTE_MAX_IT) and each residual
# reached is held below QUARTIC3_MAX_REL, about ten times the largest
# measured (on an H100 1.55e-8 f64 after 1,200 iterations, 2.29e-8 mixed
# after 1,032)
QUARTIC3_MAX_REL = 2e-7
# (iterations, relative residual, its significant digits as recorded) of
# the 33³ f64 and mixed capped solves by one launch a pass on an H100
# (PRs 17-18): a level's one launch is bitwise the same arithmetic, so
# neither may move
QUARTIC3_GOLD = {True: (1200, 1.548e-08, 4), False: (1028, 2.27e-08, 3)}



def phase_quartic():
    """Radius 5, the quartic B-spline background, on the card's
    runtime-radius instances. 2D: the biharmonic on the 513² quartic net
    (n_bg = 509, ``solve_ksp(gmres, pc='mg', stencil_radius=5)``, the f64
    default route) with host set-up per stage, counted per kernel and
    shape, a warm solve staged, profiled (idle share), peak memory, the
    outer ring's (offset 5) share of its planes; below 1e-10 in exactly
    QUARTIC_GMRES_ITERS iterations (the JAX package's cycle is as slow;
    the levels the plan gives one launch book ``smooth`` in place of their
    passes, the same arithmetic) with its L2_rel below n_bg = 253's;
    card against host at n_bg = 13 to QUARTIC_SMALL_RTOL (iterations within
    QUARTIC_SMALL_ITERS_DIFF, field within QUARTIC_SMALL_FIELD_REL, norms
    within QUARTIC_SMALL_NORMS_REL). 3D: the biharmonic on the 9³ quartic
    net card against host, each capped at two GMRES(20) cycles (relative
    residual and field within QUARTIC3_SMALL_REL), then on the
    33³ net by both routes, counted and capped (QUARTIC3_MAX_IT; the mixed
    route at OTHER_ROUTE_MAX_IT), the residual reached recorded and held
    below QUARTIC3_MAX_REL (the 3D quartic cycle does not reach 1e-10 in
    useful time), and iterations and residual held to QUARTIC3_GOLD, the
    levels given one launch booking ``smooth3`` alone. Returns {instance
    tag: (launches by kernel, by shape)}."""
    import torch

    from iifea_tpu_torch.api import l2_norm
    from iifea_tpu_torch.ops import multigrid
    from iifea_tpu_torch.ops import stencil_kernels as sk
    from iifea_tpu_torch.solvers import ksp

    gpu = torch.device("cuda", 0)
    seconds, booked = {}, {}

    def book(tag, rec):
        counts, shapes = booked.setdefault(tag, (Counter(), Counter()))
        counts.update(rec["launches"])
        shapes.update(rec["launches_by_shape"])

    t0 = time.perf_counter()
    p, M_, sh_, A_, b_, _ = build_biharmonic(N_BG_QUARTIC_RATE, gpu, 4)
    u_, info_ = bh_solve(A_, b_, sh_, radius=5)
    n_rate = p.error_norms(M_.mv(u_))
    del p, M_, A_, b_, u_
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, shape, A, b, setup = build_biharmonic(N_BG_QUARTIC, gpu, 4)
    phase("quartic_setup", n_bg=N_BG_QUARTIC, n_fg=2 * N_BG_QUARTIC,
          lattice=list(shape), n_bg_dofs=M.n_bg_dofs,
          n_fg_nodes=prob.space.n_nodes, n_block_cells=prob.cell_dom.n_elem,
          extraction_entries=M.valT.numel(), seconds=setup,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    # the smoothed levels the plan gives one launch book smooth in place of
    # their passes
    fused2 = [sh for sh in LEVELS_BH if sk._smooth_route(
        sh, 5, 1, gpu.index or 0, True) == sk.GRID]
    names2 = ("stencil_mv", "jacobi_smooth", "stencil_mv_block") + (
        ("smooth",) if fused2 else ())
    tag = instance_tag(5, True)
    u, info, rec = cubic_counted("quartic", lambda: bh_solve(A, b, shape,
                                                             radius=5),
                                 A, b, names2, MAX_GMRES_ITERS_QUARTIC)
    book(tag, rec)
    norms = prob.error_norms(M.mv(u))
    missing = [s_ for s_ in LEVELS_BH if not any(
        rec["launches_by_shape"].get(f"{k}@{s_[0]}x{s_[1]}{tag}", 0) > 0
        for k in names2)]
    stages = Counter()
    with timed_calls([(ksp, "_probe_general"),
                      (multigrid, "StencilMultigrid")], stages):
        (_, info_w), t_w = sync_time(lambda: bh_solve(A, b, shape, radius=5))
    warm = {"solve_ksp": t_w, "probe": stages["_probe_general"],
            "hierarchy": stages["StencilMultigrid"],
            "krylov": t_w - sum(stages.values()), "iters": info_w.iters}
    # profiled over one GMRES(100) cycle: the whole solve's 80 k launches
    # make the profiler's own bookkeeping the phase's largest cost
    profile = profile_stats(lambda: bh_solve(A, b, shape, radius=5,
                                             gmres_restart=100, max_it=0))
    S = ksp._probe_general(A, shape, 5, torch.float64)
    ring = ring_share(S.coeffs, 5)
    del S
    fused_passes = {f"{k}@{s_[0]}x{s_[1]}{tag}": rec["launches_by_shape"].get(
        f"{k}@{s_[0]}x{s_[1]}{tag}", 0) for s_ in fused2
        for k in ("jacobi_smooth", "stencil_mv_block", "smooth")}
    phase("quartic", n_bg=N_BG_QUARTIC, route="f64", error_norms=norms,
          error_norms_n_bg253=n_rate, iters_n_bg253=int(info_.iters),
          stages=warm, profile=profile, outer_ring_share=ring,
          fused_levels=[list(s_) for s_ in fused2], **rec)
    if missing:
        fail(f"quartic: no stencil launch at the smoothed shapes {missing}")
    if any(n != 0 for k, n in fused_passes.items()
           if not k.startswith("smooth@")) or not all(
               n > 0 for k, n in fused_passes.items()
               if k.startswith("smooth@")):
        fail(f"quartic: the levels given one launch {fused2} did not book "
             f"smooth in place of their passes: {fused_passes}")
    if info.iters != QUARTIC_GMRES_ITERS:
        fail(f"quartic: {info.iters} GMRES iterations, not the "
             f"{QUARTIC_GMRES_ITERS} of the per-pass route")
    if not norms["L2_rel"] < n_rate["L2_rel"]:
        fail(f"quartic: L2_rel {norms['L2_rel']} not below n_bg="
             f"{N_BG_QUARTIC_RATE}'s {n_rate['L2_rel']}")
    del prob, M, A, b, u
    torch.cuda.empty_cache()
    seconds["biharmonic"] = time.perf_counter() - t0

    def bh_build(n_bg, dim):
        def build(device):
            if dim == 2:
                prob, M, _, A, b, _ = build_biharmonic(n_bg, device, 4)
            else:
                prob, M, _, A, b, _, _ = build_biharmonic3(n_bg, device, 4)
            return A, b, (prob, M)
        return build

    t0 = time.perf_counter()
    small = (N_BG_QUARTIC_SMALL + 4,) * 2
    row = card_against_host(
        "quartic_small", bh_build(N_BG_QUARTIC_SMALL, 2),
        lambda A, b: bh_solve(A, b, small, radius=5,
                              rtol=QUARTIC_SMALL_RTOL),
        QUARTIC_SMALL_FIELD_REL, QUARTIC_SMALL_ITERS_DIFF)
    worst_rel = max(row["norms_rel_diff"].values())
    if not worst_rel <= QUARTIC_SMALL_NORMS_REL:
        fail(f"quartic_small: the card's norms are {worst_rel} from the "
             "host's")
    seconds["biharmonic_small"] = time.perf_counter() - t0

    # 3D: the 9³ net card against host, both capped
    t0 = time.perf_counter()
    small3 = (N_BG_QUARTIC3_SMALL + 4,) * 3
    out = {}
    for dev in ("cuda", "cpu"):
        A3, b3, (p3, M3) = bh_build(N_BG_QUARTIC3_SMALL, 3)(dev)
        (u3, i3), dt = sync_time(lambda: bh_solve(
            A3, b3, small3, radius=5, max_it=QUARTIC3_SMALL_MAX_IT,
            gmres_restart=QUARTIC3_SMALL_RESTART))
        out[dev] = (u3.cpu(), {"iters": int(i3.iters), "seconds": dt,
                               "rel_residual": rel_residual(A3, b3, u3),
                               "history": [float(h) for h in i3.history],
                               "error_norms": p3.error_norms(M3.mv(u3))})
    (u_c, card), (u_h, host) = out["cuda"], out["cpu"]
    field_rel = (l2_norm(M3.mv(u_c - u_h), p3.cell_dom)
                 / l2_norm(M3.mv(u_h), p3.cell_dom))
    res_rel = abs(card["rel_residual"] - host["rel_residual"]) / \
        host["rel_residual"]
    phase("quartic3_small", card=card, host=host, field_rel_diff=field_rel,
          rel_residual_rel_diff=res_rel)
    if not (abs(card["iters"] - host["iters"]) <= MAX_ITERS_DIFF_HOST
            and field_rel <= QUARTIC3_SMALL_REL
            and res_rel <= QUARTIC3_SMALL_REL):
        fail(f"quartic3_small: card {card} against host {host}, field "
             f"{field_rel}")
    del A3, b3, p3, M3
    seconds["biharmonic3_small"] = time.perf_counter() - t0

    # 3D: the 33³ net by both routes, capped
    t0 = time.perf_counter()
    prob, M, shape, A, b, setup3, mem = build_biharmonic3(N_BG_QUARTIC3, gpu,
                                                          4)
    phase("quartic3_setup", n_bg=N_BG_QUARTIC3, lattice=list(shape),
          n_bg_dofs=M.n_bg_dofs, n_fg_nodes=prob.space.n_nodes,
          extraction_entries=M.valT.numel(), seconds=setup3, **mem)
    for name, is64 in (("quartic3", True), ("quartic3_mixed", False)):
        fused3 = [sh for sh in LEVELS_QUARTIC3 if sk._plan3(
            sh, 5, 1, gpu.index or 0, is64)[1]]
        u, info, rec = cubic_counted(
            name, lambda: bh_solve(A, b, shape, radius=5, mixed=not is64,
                                   max_it=QUARTIC3_MAX_IT if is64
                                   else OTHER_ROUTE_MAX_IT),
            A, b, names3(LEVELS_QUARTIC3, 5, is64), gate=False)
        book(instance_tag(5, is64), rec)
        norms3 = prob.error_norms(M.mv(u))
        phase(name, n_bg=N_BG_QUARTIC3, error_norms=norms3,
              converged=rec["rel_residual"] < 1e-10,
              fused_levels=[list(s_) for s_ in fused3], **rec)
        if not rec["rel_residual"] < QUARTIC3_MAX_REL:
            fail(f"{name}: residual {rec['rel_residual']} after "
                 f"{info.iters} iterations, norms {norms3}")
        gold_iters, gold_res, digits = QUARTIC3_GOLD[is64]
        if (info.iters != gold_iters
                or float(f"{rec['rel_residual']:.{digits}g}") != gold_res):
            fail(f"{name}: {info.iters} iterations to "
                 f"{rec['rel_residual']}, not the per-pass route's "
                 f"{gold_iters} to {gold_res}")
        for s_ in fused3:
            key = "x".join(map(str, s_)) + instance_tag(5, is64)
            at_level = {k: n for k, n in rec["launches_by_shape"].items()
                        if k.endswith("@" + key)}
            if at_level.get(f"smooth3@{key}", 0) <= 0 or any(
                    at_level.get(f"{k}@{key}", 0) for k in PASSES3):
                fail(f"{name}: the level {s_} given one launch booked "
                     f"{at_level}")
    del prob, M, A, b, u
    torch.cuda.empty_cache()
    seconds["biharmonic3"] = time.perf_counter() - t0
    phase("quartic_seconds", **seconds)
    return booked


# The cubic three-field 3D elasticity where a block no longer holds every
# field's staged planes (from 73³): a 73³ cubic net (n_bg = 70; 3 × 73³ =
# 1,167,051 dofs) on a foreground of n_fg = n_bg (n_fg = 2 n_bg, the other
# cubic phases' nesting, would hold 8 times the P2 nodes), on the per-field
# staging of the f64 r = 4 three-field marching kernels. Wider nets do not
# fit the card: the block probe holds its 2,187 responses beside the planes
# (2 × 28 GB at 81³, 2 × 48 GB at the 3D elasticity cell's 97³), and at
# 81³ the planes' allocation ran out of memory on an H100 with 60 GiB held.
# GMRES(10) capped at 30 iterations (the 3D cubic cycle is weak: R11), its
# residual history recorded
N_BG_EL3_WIDE = 70
EL3_WIDE_RESTART = 10
EL3_WIDE_MAX_IT = 20       # three GMRES(10) cycles: 30 iterations


def phase_elasticity3_wide():
    """The cubic three-field 3D elasticity on the 73³ net
    (``immersed_cube_bspline_problem(n_fg=70, n_bg=70, bg_degree=3,
    n_fields=3)`` + ``ImmersedElasticityProblem(k=2)``) through
    ``solve_ksp(gmres, pc='mg', stencil_radius=4, n_fields=3)`` on the f64
    default route, counted per kernel and shape (the 73³ level's passes
    stage one field's x planes at a time: the plan's staging, checked),
    capped at 30 iterations: set-up seconds, peak device memory (below
    PEAK_GIB), the residual after each restart cycle, which must never
    rise. Returns {instance tag: (launches by kernel, by shape)}: the 73³
    level's launches under PF_TAG, the others under the instance's."""
    import torch

    from iifea_tpu_torch.ops import stencil_kernels as sk

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prob, M, shape, A, b, setup = bspline_elasticity(
        N_BG_EL3_WIDE, "cuda", 3, 3, n_fg=N_BG_EL3_WIDE)
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    plan = sk._plan3(tuple(shape), 4, N_FIELDS_EL3, 0, True)
    if tuple(shape) != SHAPE_EL3_WIDE or plan[3] != sk.PER_FIELD:
        fail(f"elasticity3_wide: lattice {shape}, plan {plan}")
    names = block_names(3, [SHAPE_EL3_WIDE], 4, N_FIELDS_EL3, True)
    u, info, rec = cubic_counted(
        "elasticity3_wide",
        lambda: bspline_el_solve(A, b, shape, 3, radius=4,
                                 gmres_restart=EL3_WIDE_RESTART,
                                 max_it=EL3_WIDE_MAX_IT),
        A, b, names, gate=False)
    history = [float(h) / float(torch.linalg.vector_norm(b))
               for h in info.history]
    key = "x".join(map(str, (N_FIELDS_EL3, *shape))) + instance_tag(4, True)
    wide = {k: n for k, n in rec["launches_by_shape"].items()
            if k.split("@")[1] == key}
    tag = instance_tag(4, True, N_FIELDS_EL3)
    rest = dict(rec, launches={k: n - wide.get(f"{k}@{key}", 0)
                               for k, n in rec["launches"].items()},
                launches_by_shape={k: n for k, n in
                                   rec["launches_by_shape"].items()
                                   if k not in wide})
    pf = {"launches": {k.split("@")[0]: n for k, n in wide.items()},
          "launches_by_shape": {k + "/pf": n for k, n in wide.items()}}
    phase("elasticity3_wide", n_bg=N_BG_EL3_WIDE, n_fg=N_BG_EL3_WIDE,
          lattice=list(shape), n_bg_dofs=M.n_bg_dofs,
          n_fg_nodes=prob.space.n_nodes, setup_seconds=setup,
          setup_peak_gib=setup_peak, plan=list(plan),
          rel_residual_history=history,
          error_norms=prob.error_norms(M.mv(u)), **rec)
    if not rec["peak_gib"] < PEAK_GIB:
        fail(f"elasticity3_wide: peak {rec['peak_gib']} GiB")
    if any(h1 > h0 for h0, h1 in zip(history, history[1:])):
        fail(f"elasticity3_wide: the residual rose: {history}")
    if min(pf["launches"].get(k, 0) for k in names) <= 0:
        fail(f"elasticity3_wide: a pass did not launch at {shape}: {pf}")
    del prob, M, A, b, u
    torch.cuda.empty_cache()
    return {tag: (Counter(rest["launches"]),
                  Counter(rest["launches_by_shape"])),
            PF_TAG: (Counter(pf["launches"]),
                     Counter(pf["launches_by_shape"]))}


PHASES = ("device", "build", "kernels", "kernels3", "small_reference",
          "small_reference3", "main_path", "main_path3", "demo",
          "elasticity", "demo_elasticity", "elasticity3", "newton", "asm",
          "small_reference_biharmonic", "biharmonic", "demo_biharmonic",
          "demo_p2", "small_reference_biharmonic3", "biharmonic3",
          "demo_biharmonic3", "navier_stokes", "shells", "poisson_unfitted",
          "determinism", "mesh_files", "f64_routes", "cubic", "quartic",
          "elasticity3_wide", "sharded")


def kernel_shapes(timing, by_shape):
    """Each timed (kernel, shape[, form]) with its main-path launches (for
    a ``smooth_call`` row: calls), and per kernel the launches × (device ms
    − bound ms) summed over the shapes. A ``smooth_call`` row books a whole
    smoothing call; where it is routed to one launch per pass, those
    launches also stand under ``jacobi_smooth`` and ``stencil_mv_block``."""
    def key(r):
        form = f":{r['form']}" if "form" in r else ""
        tag = instance_tag(r["radius"], r["dtype"] == "f64")
        if r.get("staging") == "per_field":
            tag += "/pf"
        return (f"{r['kernel']}@{'x'.join(map(str, r['shape']))}{tag}"
                f"{form}")

    rows, excess = [], Counter()
    for r in timing:
        n = by_shape.get(key(r), 0)
        rows.append({**r, "launches": n})
        excess[r["kernel"] + r["instance"]] += n * (r["device_ms"]
                                                 - r["bound_ms"])
    timed = {key(r) for r in timing}
    phase("kernel_shapes", rows=rows, excess_ms=dict(excess),
          untimed={k: v for k, v in by_shape.items() if k not in timed})
    return rows


# phases that time no kernel and feed no count or record of this process
# (the shells, poisson_unfitted and the mesh-file door solve by host LU or
# the general operator; the sharded phase's ranks count their own launches):
# they run in a child process beside the phases that follow the kernels'
# timings, and their lines are printed before the determinism phase; the
# child's phase seconds are reported apart
CHILD_PHASES = ("shells", "poisson_unfitted", "mesh_files", "sharded")


def start_child(names, backend: str):
    """``chip_smoke.py --child`` running the phases ``names`` in a session
    of its own, its output piped; the session (the child and the ranks it
    spawns) is killed if this process exits first."""
    import atexit
    import signal
    import threading

    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         ",".join(names), "--backend", backend], stdout=subprocess.PIPE,
        text=True, cwd=HERE, start_new_session=True)
    # its lines are read as they come, so a full pipe never stalls it
    proc.lines = []
    proc.reader = threading.Thread(
        target=lambda: proc.lines.extend(proc.stdout), daemon=True)
    proc.reader.start()

    def stop():
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    atexit.register(stop)
    return proc


def finish_child(proc) -> float:
    """Wait for the child, print its lines; fails where it failed. Returns
    the seconds this process waited for it."""
    import signal

    t = time.perf_counter()
    proc.wait()
    waited = time.perf_counter() - t
    # nothing of its session outlives it (the ranks hold the pipe too)
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.reader.join()
    for line in proc.lines:
        print(line, end="", flush=True)
    if proc.returncode != 0:
        fail(f"the child phases {CHILD_PHASES} exited {proc.returncode}")
    return waited


def run_child(names, backend: str) -> None:
    """The child's side: each phase of ``names`` in turn, then its
    seconds."""
    seconds = {}
    fns = {"shells": phase_shells, "poisson_unfitted": phase_poisson_unfitted,
           "mesh_files": phase_mesh_files,
           "sharded": lambda: phase_sharded(backend=backend)}
    for name in names:
        t = time.perf_counter()
        fns[name]()
        seconds[name] = time.perf_counter() - t
    phase("child_phase_seconds", **seconds)


def main() -> None:
    args = sys.argv[1:]
    run = set(PHASES)
    backend = "gloo"
    if args[-2:-1] == ["--backend"]:
        backend, args = args[-1], args[:-2]
    if args[:1] == ["--child"] and len(args) == 2:
        run_child(args[1].split(","), backend)
        return
    if args[:1] == ["--phases"] and len(args) == 2:
        run = set(args[1].split(",")) | {"device", "build"}
    elif args:
        fail(f"usage: chip_smoke.py [--phases {','.join(PHASES)}] "
             "[--backend gloo|nccl]")
    t0 = time.perf_counter()
    worst, timing, launches, by_shape = {}, [], Counter(), Counter()
    seconds = {}
    F64_ON["on"] = "f64_routes" in run

    def run_phase(name, fn):
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        return out

    run_phase("device", phase_device)
    run_phase("build", phase_build)
    for name, fn in (("kernels", phase_kernels),
                     ("kernels3", phase_kernels3)):
        if name in run:
            w, t = run_phase(name, fn)
            worst.update(w)
            timing += t
    child_names = [n for n in CHILD_PHASES if n in run]
    child = start_child(child_names, backend) if child_names else None
    for name, fn in (("small_reference", phase_small_reference),
                     ("small_reference3", phase_small_reference3)):
        if name in run:
            run_phase(name, fn)
    # each main path's counted solve; the 2D and elasticity solves both
    # launch stencil_mv, and Counter.update adds their counts
    for name, fn in (("main_path", phase_main_path),
                     ("main_path3", phase_main_path3),
                     ("demo", phase_demo),
                     ("elasticity", phase_elasticity),
                     ("demo_elasticity", phase_demo_elasticity),
                     ("elasticity3", phase_elasticity3),
                     ("newton", phase_newton),
                     ("asm", phase_asm)):
        if name in run:
            counts = run_phase(name, fn)
            if counts is not None:
                launches.update(counts[0])
                by_shape.update(counts[1])
    # the biharmonics' instances (radius 3, f64 or f32) are booked apart
    for name, fn in (("small_reference_biharmonic",
                      phase_small_reference_biharmonic),
                     ("demo_biharmonic", phase_demo_biharmonic),
                     ("demo_p2", phase_demo_p2),
                     ("small_reference_biharmonic3",
                      phase_small_reference_biharmonic3),
                     ("demo_biharmonic3", phase_demo_biharmonic3)):
        if name in run:
            run_phase(name, fn)
    # the three-field 2D instances' launches come from the Taylor-Green
    # cell alone
    ns = None
    if "navier_stokes" in run:
        ns, ns_shapes = run_phase("navier_stokes", phase_navier_stokes)
        by_shape.update(ns_shapes)
    # the child's phases (CHILD_PHASES); the determinism gate repeats the
    # Taylor-Green cell's first solve
    if child is not None:
        seconds["child_wait"] = finish_child(child)
    if "determinism" in run:
        run_phase("determinism", phase_determinism)
    # the f64 and radius-3 routes: their instances' checks and rows, and
    # their launches by instance tag (the full-width f64 runs made inside
    # the phases above, the B-spline elasticity's here)
    f64_tags = {}
    if "f64_routes" in run:
        w, t, f64_tags = run_phase("f64_routes", phase_f64_routes)
        worst.update(w)
        timing += t
        for _, shapes in f64_tags.values():
            by_shape.update(shapes)
    # {instance tag: (launches by kernel, by shape)}, added up over the
    # phases that launch an instance: the 2D and the 3D biharmonic (radius
    # 3), the cubic paths (radius 4), the quartic paths' runtime-radius
    # instances (radius 5) and the per-field staging's elasticity
    # (elasticity3_wide, last: it takes most of the card), whose levels
    # below its widest one launch the cubic elasticity's instance
    bh = {}
    for name, fn in (("biharmonic", phase_biharmonic),
                     ("biharmonic3", phase_biharmonic3),
                     ("cubic", phase_cubic), ("quartic", phase_quartic),
                     ("elasticity3_wide", phase_elasticity3_wide)):
        if name in run:
            for tag, (counts, shapes) in run_phase(name, fn).items():
                merged = bh.setdefault(tag, (Counter(), Counter()))
                merged[0].update(counts)
                merged[1].update(shapes)
                by_shape.update(shapes)
    import torch

    kernel_shapes(timing, by_shape)
    check_shares(timing)
    phase("phase_seconds", **seconds)
    phase("elapsed", seconds=time.perf_counter() - t0)
    if run != set(PHASES):
        fail(f"only phases {sorted(run)} ran: no result")
    rows = []
    # the r = 3 instances' launches come from the biharmonic's solves (the
    # route taken, and the other one)
    instances = ([("", launches)] + [(tag, bh[tag][0]) for tag in sorted(bh)]
                 + [(instance_tag(n_fields=N_FIELDS_NS), ns)]
                 + [(tag, f64_tags[tag][0]) for tag in sorted(f64_tags)])
    for tag, counts in instances:
        for name, (source, replaces) in KERNELS.items():
            if tag and name not in counts:
                continue
            # a fused smoothing call is one launch of "smooth" ("smooth3"),
            # timed where the plan gives the level that launch
            timed_as = {"smooth": "smooth_call",
                        "smooth3": "smooth3_call"}.get(name, name)
            found = [r for r in timing
                     if r["kernel"] == timed_as and "plain_ms" in r
                     and r["instance"] == tag]
            if len(found) != 1 or (timed_as != name
                                   and found[0].get("route") != "grid"):
                fail(f"{name}{tag}: the summary needs one row timed with "
                     f"its plain version by its own kernel, got {found}")
            t = found[0]
            row = {"name": name, "route": "cuda",
                   "source": (SOURCE_RN if t["radius"] > 4
                              and source == SOURCE2 else source),
                   "replaces": replaces, "launches": counts[name],
                   "max_abs_err": worst[name + tag], "ms": t["device_ms"],
                   "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"],
                   "library_ms": t.get("library_ms")}
            if tag:
                row["instance"] = tag.strip("/").replace("/", " ")
            rows.append(row)
    listed = {(r["name"], r.get("instance", "")) for r in rows}
    missing = [(name, tag) for tag, names in SUMMARY_ROWS.items()
               for name in names if (name, tag) not in listed]
    unlaunched = [(r["name"], r.get("instance", "")) for r in rows
                  if r["launches"] <= 0]
    if missing or unlaunched:
        fail(f"the kernels line lacks the rows {missing}, and holds rows no "
             f"path launched: {unlaunched}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
