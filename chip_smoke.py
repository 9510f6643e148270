"""Smoke run of the amg_tpu_torch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1-K12) from amg_tpu_torch/csrc, checks
each against its plain PyTorch version on the card and times both (K1, K2
and K3 bitwise at M = 513, 512, 2048, 4096, 1024, 256 and 128, every size
the solves give them, and timed at 512, 2048 and 4096;
K4's r.hi bitwise at M = 101, 129, 512, 2048 and 4096 and timed at the last
three; K5 and K6 bitwise at n = 1000, 1023 and 4095; K8 bitwise at M = 101
and 4096; K9 bitwise, and to K1 through the layouts, at M = 101, 512,
2048 and 4096 and timed in turns with K1 at the last two; K7 per call
against index_select and on the device, in a CUDA graph; the loop
graphs' condition kernel in toy loops against the host driver over the
condition's edge cases, and per pass; the masked V-cycle's legs K10/K11
bitwise against their plain twins at every masked entry from 127^2 down,
each alone and a whole masked V-cycle as a CUDA graph against the plain
ops' timed at 127^2; the masked sweep on planes K12 bitwise against the
plain masked sweep at every side of the 4095^2 hierarchy below the fine
level on Kellogg's planes and a Galerkin level of them, timed against it
at 2047^2 and 255^2, each as a CUDA graph), then drives the solves through
the user entry points with an independent f64 residual check and the
kernels' launch counts. StructuredSolver's solve loops and
solve_pcg_device run as one CUDA graph a solve (JAX's one-program
loops), and JAX's host loops over a jitted program (solve_ir's refine,
solve_stencil's and multigrid.solve's chunks of V-cycles, the
distributed solvers' programs) as a graph a program run:

* the constant-coefficient Poisson df32 solve (StructuredSolver ->
  prepare_b -> solve_ir_device_prepared -> finalize_u) at 1023^2 and
  4095^2 (K2-K4), and at 1023^2 with two sweeps (K1);
* the same solve at 8191^2, whose fine level is split (K1, K8, K3), and
  one V-cycle there with the split level against one with legs (K2/K3);
* the AMG-preconditioned CG (solve_pcg_device, f32, 1e-5, fused) at
  2047^2 and 4095^2 (K2/K3), and the card against the CPU at 1023^2;
* the variable-coefficient jump problem (a = 100, models/varcoef.py)
  through solve_ir_device: smoother="auto" at 2047^2 and 4095^2 (no
  kernel), smoother="fused" at 4095^2 (K6), precision="f64" at 4095^2;
* the constant problem with smoother="fused" at 4095^2 (K5);
* the card against the port's own CPU solve at 1023^2 (constant) and
  255^2 (variable);
* at 4095^2 the host-stepped solve_ir (K2/K3) and the packed loop with
  fmg=False (K2-K4), and smoother="masked" (K10/K11 from 127^2 down),
  "strided" and "chebyshev" (no kernel);
* host-built hierarchies: the jump operator as a scipy matrix (A_fine) at
  2047^2, and the card against the CPU for solve_stencil (f64, 1023^2,
  1e-9) and the free solve_ir (511^2);
* the loop graphs (phase graph_solves): constant 1023^2, 4095^2, 8191^2,
  fused 4095^2, the jump problem fused at 1e-5 and f64 at 1e-7 (4095^2),
  PCG at 2047^2 and 4095^2; each row's capture seconds and memory, one
  graph launch under set_sync_debug_mode("error") that returns before
  the solve ends, u and stats bitwise the host-driven oracle's, the
  refines of the row and the launch counts, and the graph's and the host
  loop's wall, device busy and idle share; then the host-stepped rows:
  StructuredSolver.solve_ir at 4095^2 (a refine graph a step, K2/K3
  inside) and solve_stencil for 4 V-cycles on the constant fused 4095^2
  hierarchy (K5 inside its chunk graphs), each bitwise its host driver,
  with graph launches, dispatch, capture, walls and idle share;
* DistStructuredSolver's five JAX programs as CUDA graphs (phase
  dist_graph_solves, the solvers of the distributed phases taken on): one
  block of 4 slabs at 4095^2 ("rdma": solve_ir_fused to 1e-7, the f32
  PCG to 1e-5), the jump f64 solve (20 V-cycles, a vcycle graph each),
  and a card group of two blocks on the one card ("rdma", "sweep"), each
  against the host driver of the same pieces (bitwise, one graph launch
  a block under set_sync_debug_mode("error"), the launch counts) and one
  block (u bitwise, the counts), with capture, dispatch, walls and the
  one-block rows' idle share; then the peer collective kernel (the card
  group's collectives inside the graphs) against its plain version at
  the path's payloads, bitwise and timed;
* the ELL path's programs as CUDA graphs (phase ell_graph_solves, the
  solvers of ell_solves, ell_dist_solves and card_solves taken on): the
  1023^2 Multigrid (a) solve (a chunk graph a V-cycle and an rss graph a
  check), EllDistSolver at 1023^2 on 4 slabs ("step" and "strips" solve,
  the f64 PCG in one WHILE launch, the f32 solve_ir with a refine graph
  a step, the flat 12-level solve) and its card group of two blocks on
  the one card ("strips", bitwise one block's graph solve), each bitwise
  the host driver of the same pieces, with graph launches, dispatch,
  capture, walls and idle share;
* the reference-parity ELL pipeline (plain PyTorch, no kernel): the
  testlib numbers at 35^2 (Multigrid with symmetric GS: 35 V-cycles to
  rss 7.19199e-11; the standalone GS: 900 sweeps) and the other
  smoothers under Multigrid; at 1023^2 Multigrid with the bilinear
  transfer and multicolor GS (host scipy RAP) to 1e-9 and the device RAP
  hierarchy (build_hierarchy_device, 12 levels) for 20 V-cycles, with the
  setup split, walls, device busy and launches, and the value rebuild
  against a fresh build; both at 255^2 on the card against the CPU (the
  device RAP's levels bitwise);
* the distributed solve (DistStructuredSolver, 4 row slabs on the card)
  at 4095^2 with halo="rdma" (K7) and "sweep", one V-cycle per halo mode
  at 1023^2 on 8 slabs, and the card against the CPU at 255^2;
* the rest of the distributed layer, plain PyTorch (no kernel of K1-K9):
  the jump problem on variable sharded levels (4095^2, 4 slabs, f64,
  solve to 1e-7; "sweep" against "step" at 1023^2 on 8 slabs; the card
  against the CPU at 255^2), halo="packed" against "sweep" (4095^2,
  solve_ir_fused), the distributed PCG (4095^2 f32 to 1e-5 on the
  "packed" solver; the jump problem at 255^2 in f64, the card against
  the CPU on the solver of the var check), EllDistSolver
  (1023^2 on 4 slabs: the bilinear pipeline under "step" and "strips"
  against the single-device Multigrid's history, its f32 solve_ir and
  f64 solve_pcg; the flat reference pipeline, 20 V-cycles against the
  single-device Multigrid), and 2 processes under gloo on the one card,
  each holding 2 of 4 slabs, against one process (the launch path, not
  NCCL; with a card a process they take nccl); each with its wall,
  setup, idle share and launches a V-cycle;
* in those 2 processes, K7's peer form (it puts into the other
  process's memory, mapped through CUDA IPC): bitwise against its plain
  version (launch.strips) in f32 and f64, a lost neighbour's bounded
  wait, its per-exchange time against the plain exchange, and the
  4095^2 D = 4 halo="rdma" solve across the processes
  against the one-process run (the same V-cycles, u bitwise, K7 14 a
  V-cycle in each process);
* one process driving two blocks on the one card (a card group,
  ``device=("cuda:0", "cuda:0")``, a thread and a stream a block): K7's
  in-process form bitwise against its plain version in f32 and f64, a
  lost neighbour, its per-exchange time; the 4095^2 D = 4 solve under
  "rdma" and "overlap" and EllDistSolver "strips" at 1023^2 against one
  block (the same V-cycles, u bitwise, the rss within 1e-12), each with
  its wall and, per card, the idle share and launches a V-cycle;
* the native setup engine (amg_tpu_torch/native, host C++ as in JAX):
  built and loaded, its Galerkin chain at 2047^2 against scipy's, its
  coloring of a 1023^2 level against the Python loop, and the C++
  single-thread baseline (cpu_vcycle_solve) at 1023^2, best of 3, beside
  the port's constant 1023^2 wall as vs_baseline;
* in the 2 worker processes, after their own checks, the mesh of 2
  processes x 2 blocks, all four on the one card (JAX's multi-host
  mesh): K7's peer form across both kinds of neighbour (a block of the
  same process, a block of the other) bitwise against its plain version
  in f32 and f64, a lost neighbour, its per-exchange time; the 4095^2 D =
  4 "rdma" solve against the one-block run (the same V-cycles, u
  bitwise, K7 14 a V-cycle a block); EllDistSolver "strips" at 1023^2
  against the one-block history;
* the distributed programs as CUDA graphs across processes (ROADMAP 6c
  step 3), in those workers after their host rows, for the 2 processes
  and then for the 2 x 2 mesh: DistStructuredSolver 4095^2 D = 4
  "rdma" solve_ir_fused to 1e-7 and the f32 solve_pcg to 1e-5, and
  EllDistSolver 1023^2 "strips" solve and solve_pcg, each against the
  host driver of the same processes (u, counts, stats and histories
  bitwise; one graph launch a program a block under
  set_sync_debug_mode("error"); the launch counts, K7 14 a V-cycle a
  block and the peer collective) and the one-process runs (u bitwise,
  the counts; an independent f64 rss), with capture, dispatch and walls
  beside the host driver's; then the peer collective kernel across the
  processes against its plain version (torch.distributed), bitwise and
  timed.

K9, the sweep on the row-grouped layout, is on no path (no JAX solver
calls it): its launches are those of its parity phase. Each phase prints
its seconds. Any failed check raises, so the exit code is non-zero. The
line before the last of stdout is the card's name and power limit, the
one before it the kernels' JSON (K1-K9, then K7's peer form as
rdma_halo_exchange_peer, from process 0, and its in-process form as
rdma_halo_exchange_cards, from block 0, and its mesh form as
rdma_halo_exchange_mesh, from block 0 of process 0; loop_condition, the
loop graphs' condition kernel, and peer_collective, the collectives
inside the distributed graphs, which replace no TPU kernel, the latter
also across processes as peer_collective_processes and
peer_collective_mesh, from process 0; masked_down_leg and masked_up_leg,
K10/K11, the masked levels' V-cycle, which replace no TPU kernel either:
every path whose cycles reach the constant masked levels on the card runs
them; masked_gs4_sweep_var, K12, the masked sweep on planes, which every
path that sweeps a plane level masked on the card runs); the last
line is one JSON object with "ok" and the device. ``--mp P [P ...]``
runs the process phase alone for each P (with P cards, nccl and a card
each); ``--cards
N`` one process driving N visible cards (K7 between them, the 4095^2
solve on N and 2N slabs against one block, 8191^2 on N while its setup
stays under 60 s; ``--cards N --graph-rows`` its graph rows alone);
``--mp P --cards K`` the mesh alone, P processes of
K cards each (nccl; K7 by peer access inside a process, through CUDA IPC
across). Needs a CUDA device, nvcc and g++; imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from torch.profiler import ProfilerActivity, profile

from amg_tpu_torch import (ELL, BilinearInterpolator2D, DistStructuredSolver,
                           Jacobi, LinearInterpolator,
                           MulticolorGaussSeidel, Multigrid,
                           SparseGaussSeidel, StructuredSolver,
                           SuccessiveOverRelaxation, build_stencil_hierarchy,
                           build_stencil_hierarchy_device, poisson, solve,
                           solve_ir, solve_pcg_device, solve_stencil,
                           varcoef, vcycle_packed)
from amg_tpu_torch.multigrid import (build_hierarchy_device,
                                     rebuild_hierarchy_values)
from amg_tpu_torch.native import bindings
from amg_tpu_torch.ops import kernels as K
from amg_tpu_torch.ops.doublefloat import DF32, is_pow2_weights
from amg_tpu_torch import krylov, multigrid, structured
from amg_tpu_torch.ops.kernels import _build, graph_loop
from amg_tpu_torch.ops.kernels.packed_cycle import (down_leg_plain,
                                                    residual_restrict_plain,
                                                    up_leg_plain)
from amg_tpu_torch.ops.kernels.masked_cycle import (
    masked_down_leg, masked_down_leg_plain, masked_up_leg,
    masked_up_leg_plain, workspace_floats)
from amg_tpu_torch.ops.kernels.halo import (rdma_halo_exchange_peer,
                                            rdma_halo_exchange_plain)
from amg_tpu_torch.ops.kernels.packed_df import df_residual_rss_plain
from amg_tpu_torch.ops.kernels.packed_rm import (from_rm,
                                                 fused_gs4_sweep_rm_plain,
                                                 to_rm)
from amg_tpu_torch.ops.kernels.rbgs import (fused_gs4_sweep_plain,
                                            masked_gs4_sweep_var)
from amg_tpu_torch.ops.rap import poisson_const_w33, rap_stencil_planes
from amg_tpu_torch.ops.transfer import linear_interp_1d
from amg_tpu_torch.parallel import launch
from amg_tpu_torch.parallel.ell_dist import EllDistSolver
from amg_tpu_torch.parallel.structured_dist import ghost_rows
from amg_tpu_torch.sparse.packed import gs4_sweep_packed, pack
from amg_tpu_torch.sparse.stencil import (Stencil2D, color_masks_iota,
                                          gs4_sweep_masked)
from amg_tpu_torch.structured import (PACKED_MIN_SIDE, galerkin_chain,
                                      level_plan, max_levels_for_side)
from amg_tpu_torch.utils.coloring import (greedy_coloring,
                                          greedy_coloring_loop)
from amg_tpu_torch.utils.profiling import _device_us

TOL = 1e-7
# K4: M = 101 and 129 (ragged: 4-byte copies, edge tiles), then the timed
# sizes M = 512, 2048 and 4096 (the 1023^2, 4095^2 and 8191^2 fine levels)
PARITY_SIDES = (201, 257, 1023, 4095, 8191)
DF_TIMED = (1023, 4095, 8191)
# K1, K2, K3 (the windowed kernels): M = 513 (ragged: 4-byte copies, edge
# tiles), the timed sizes M = 512, 2048 (the legs' fine levels) and 4096
# (8191^2's fine level), then the legs' other levels, M = 1024, 256 and 128
# (2047^2, 511^2, 255^2)
WINDOW_SIDES = (1025, 1023, 4095, 8191, 2047, 511, 255)
WINDOW_TIMED = (1023, 4095, 8191)
# their weight instantiations besides the fine level's 5-point Poisson
# weights: a Galerkin level's 9-point pattern and another zero pattern
WINDOW_WEIGHTS = {"nine": ((-0.5, -1.0, -0.5), (-1.0, 6.0, -1.0),
                       (-0.5, -1.0, -0.5)),
              "other": ((0.0, -1.0, -0.5), (-1.0, 4.5, -1.0),
                        (0.0, -1.0, 0.0))}
SOLVE_SIDES = (1023, 4095)
RBGS_SIDES = (1000, 1023, 4095)        # K5/K6 run at 4095 on the path
# K7 shapes (D slabs, B rows, n columns, G strip rows): the 4095^2 D = 4
# solve's fine level first, then small meshes; n = 256 takes the 16-byte
# copies
HALO_SHAPES = ((4, 1024, 4095, 10), (2, 10, 31, 10), (8, 10, 31, 10),
               (4, 64, 256, 10))
K7_GRAPH_LAUNCHES = 20
DIST_SIDE, DIST_SLABS = 4095, 4
# K7's peer form across the processes (global D slabs, B, n, G): the
# 4095^2 D = 4 solve's fine level, then a small mesh; each process holds
# D / P of the slabs
PEER_SHAPES = ((4, 1024, 4095, 10), (8, 10, 31, 10))
PEER_EPOCHS = 3                # calls per parity check: both slots, twice
PEER_TIMEOUT_TEST_S = 0.5      # the bound of the deliberately lost wait
SPLIT_SIDE = 8191                      # the split fine level, M = 4096
K8_SIDES = (201, 8191)                 # M = 101 (ragged) and 4096
# K9: M = 101 (ragged), 512, 2048, 4096; timed at the last two
K9_SIDES = (201, 1023, 4095, 8191)
K9_TIMED = (4095, 8191)
PCG_SIDES = (2047, 4095)               # bench.py pcg_stats
REFINE_SIDE = 4095       # solve_ir, fmg=False and the unpacked smoothers
REFINE_STEPS = 5         # solve_ir's steps there to TOL, the stopping one
# solve_stencil on the constant fused REFINE_SIDE^2 hierarchy (K5): a fixed
# count of V-cycles, the rss read every STENCIL_GRAPH_EVERY
STENCIL_GRAPH_EVERY, STENCIL_GRAPH_CYCLES = 2, 4
HOST_JUMP_SIDE = 2047    # the jump operator given as a scipy matrix
STENCIL_SIDE = 1023      # solve_stencil, f64, card against CPU
FREE_IR_SIDE = 511       # the free solve_ir, card against CPU
# the ELL pipeline: the reference's testlib problem (BASELINE.md:11-16), the
# general path at bench.py's headline side (benchmarks/scenarios.py
# large_multicolor), and the card against the CPU at 255^2
ELL_TESTLIB_SIDE, ELL_TESTLIB_LEVELS = 35, 8
ELL_TESTLIB_DOFS = [1225, 612, 305, 152, 75, 37, 18, 8]
ELL_TESTLIB_CYCLES, ELL_TESTLIB_RSS, ELL_TESTLIB_SWEEPS = 35, 7.19199e-11, 900
ELL_SIDE = 1023
ELL_BILINEAR_LEVELS = 9           # 1023 -> 511 -> ... -> 3
ELL_DEVICE_LEVELS = 12            # the flattened structure, down to 510 dofs
ELL_DEVICE_COARSEST = 510
ELL_DEVICE_CYCLES, ELL_DEVICE_EVERY = 20, 5
ELL_CHECK_SIDE, ELL_CHECK_BILINEAR, ELL_CHECK_DEVICE = 255, 7, 10
ELL_TOL = 1e-9
ELL_CARD_CPU_REL = 1e-10          # rss history, card against the CPU
ELL_REBUILD_REL = 1e-13           # rebuild against a fresh build
PCG_TOL = 1e-5
PCG_TPU_ITERS = 5                      # BENCH_r05.json, TPU v5e, both sides
# max|u - u_df32| / max|u_df32| of the f32 PCG at tol 1e-5 (H100 readings
# 3.0e-5 at 2047^2, 1.4e-4 at 4095^2), and the card's 1023^2 PCG against
# the CPU's relative to max|u| (reading 8.9e-8 absolute)
PCG_REL_U = 1e-3
PCG_CARD_CPU_REL = 1e-5

# H100 SXM data-sheet peaks (700 W): device memory rate and f32 outside
# the tensor cores; the least time of a kernel is the larger of its
# bytes over the first and its f32 operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# NVLink 4 between two cards of one host: 900 GB/s in all, 450 each way
NVLINK_BYTES_PER_S = 450e9

# Kernel-vs-plain bound, |kernel - plain| / |plain|, for the one output
# not held bitwise (K1, K2, K3, K5, K6, K8, K9 and K4's r.hi are:
# torch.equal): K4's rss, summed in another order than the plain
# version's row sums; the JAX package's own interpret-mode bound for that
# kernel (tests/test_packed_df.py).
BOUND = {"df_rss": 1e-5}

# the rest of the distributed layer (plain PyTorch): the jump problem on
# 4 slabs at 4095^2, one V-cycle per halo mode at 1023^2 on 8 slabs, the
# card against the CPU at 255^2; the ELL solver on 4 slabs at 1023^2; two
# processes, each with 2 of 4 slabs (1023^2 structured, 255^2 ELL)
DIST_VAR_SIDE, DIST_VAR_TOL = 4095, 1e-7
DIST_VCYCLE_SIDE, DIST_VCYCLE_SLABS = 1023, 8
DIST_CHECK_SIDE, DIST_CHECK_TOL = 255, 1e-9
ELL_DIST_SLABS = 4
ELL_A_CYCLES = 7                  # the single-device Multigrid (a)
ELL_FLAT_LEVELS, ELL_FLAT_CYCLES = 12, 20
# one process driving several cards (a card group, parallel/launch.py):
# two blocks on the one card; with --cards N the 4095^2 solve on D = N and
# 2N slabs and the 8191^2 one on N, the last only while its setup stays
# under CARDS_BIG_SETUP_S
CARD_BLOCKS = 2
CARDS_BIG_SIDE, CARDS_BIG_SETUP_S = 8191, 60.0
CARD_RTOL = 1e-12                 # the rss: only the order of the sums
MP_PROCS, MP_SLABS, MP_CYCLES = 2, 4, 10
MP_SIDE, MP_ELL_SIDE, MP_ELL_LEVELS = 1023, 255, 7
MP_RTOL = 1e-12                   # only the order of the sums differs
MP_TIMEOUT = 480                  # seconds, for all the workers
# the native engine: its chain against scipy's (the same terms summed in
# another order), the coloring of the chain's 1023^2 level, bench.py's
# C++ baseline at 1023^2, best of 3
NATIVE_RAP_SIDE, NATIVE_RAP_RTOL = 2047, 1e-13
BASELINE_SIDE, BASELINE_RUNS = 1023, 3
# the mesh: 2 processes x 2 blocks (on the one card inside mp_solves'
# workers; P processes of K cards each with --mp P --cards K)
MESH_PROCS, MESH_BLOCKS = 2, 2
TRACE_CYCLES = 2                  # the traced window of a distributed path
# what later phases print beside their own numbers: the single-device
# PCG's iterations (pcg_solves), the ELL (a) history (ell_solves)
RECORD = {}

KERNEL_INFO = {
    "fused_gs4_sweep_packed": ("amg_tpu_torch/csrc/packed_sweep.cu",
                               "amg_tpu/ops/pallas/packed_rbgs.py:674"),
    "fused_down_leg_packed": ("amg_tpu_torch/csrc/packed_cycle.cu",
                              "amg_tpu/ops/pallas/packed_cycle.py:186"),
    "fused_up_leg_packed": ("amg_tpu_torch/csrc/packed_cycle.cu",
                            "amg_tpu/ops/pallas/packed_cycle.py:465"),
    "fused_df_residual_rss": ("amg_tpu_torch/csrc/packed_df.cu",
                              "amg_tpu/ops/pallas/packed_df.py:258"),
    "fused_gs4_sweep_const": ("amg_tpu_torch/csrc/rbgs_sweep.cu",
                              "amg_tpu/ops/pallas/rbgs.py:544"),
    "fused_gs4_sweep_var": ("amg_tpu_torch/csrc/rbgs_var.cu",
                            "amg_tpu/ops/pallas/rbgs.py:584"),
    "rdma_halo_exchange": ("amg_tpu_torch/csrc/halo.cu",
                           "amg_tpu/ops/pallas/halo.py:103"),
    "fused_residual_restrict_packed": (
        "amg_tpu_torch/csrc/packed_cycle.cu",
        "amg_tpu/ops/pallas/packed_cycle.py:300"),
    "fused_gs4_sweep_rm": ("amg_tpu_torch/csrc/packed_sweep.cu",
                           "amg_tpu/ops/pallas/packed_rm.py:224"),
    # not a TPU kernel: the loop graphs' condition, in place of the
    # while_loop cond of JAX's one-program solve loop
    "loop_condition": ("amg_tpu_torch/csrc/graph_loop.cu",
                       "amg_tpu/structured.py:1000"),
}
LOOP = "loop_condition"
# not a TPU kernel: a card group's collectives inside its loop graphs, in
# place of the psum / all_gather / ppermute of JAX's shard_map programs
# (the loop's psum'd rss, amg_tpu/parallel/structured_dist.py:1038)
PEER = "peer_collective"
KERNEL_INFO[PEER] = ("amg_tpu_torch/csrc/peer_collective.cu",
                     "amg_tpu/parallel/structured_dist.py:1038")
# the distributed programs as CUDA graphs (phase dist_graph_solves): the
# jump solve's V-cycles (DIST_VAR_SIDE^2, every 5th checked: 20), and the
# peer collective's calls a timing (two blocks on the one card)
DIST_GRAPH_PCG_TOL = 1e-5
PEER_REPS = 50
# processes that share one card time-slice it: every call of the peer
# collective there is a context switch (~2.2 ms), whatever its payload
PEER_REPS_SHARED = 10
# not TPU kernels: the masked V-cycle's legs K10/K11 (csrc/masked_cycle.cu),
# in place of the plain jnp ops of JAX's cycle_stencil on the masked levels
MASKED_LEGS = ("masked_down_leg", "masked_up_leg")
for _name in MASKED_LEGS:
    KERNEL_INFO[_name] = ("amg_tpu_torch/csrc/masked_cycle.cu",
                          "amg_tpu/structured.py cycle_stencil")
# K10/K11's parity entries (the Poisson hierarchy's masked levels), and
# the entry timed: the solves' 127^2
MASKED_TIMED = 127
MASKED_GRAPH_LAUNCHES = 20
# not a TPU kernel: the masked sweep on planes K12 (csrc/rbgs_var.cu), in
# place of the plain jnp masked sweeps of JAX's cycle_stencil on the
# variable levels; its parity sides (the 4095^2 hierarchy below the fine
# level, and two sides that are not 2^k - 1) and the sides timed
MASKED_SWEEP = "masked_gs4_sweep_var"
KERNEL_INFO[MASKED_SWEEP] = ("amg_tpu_torch/csrc/rbgs_var.cu",
                             "amg_tpu/structured.py cycle_stencil")
K12_SIDES = (7, 15, 31, 63, 127, 255, 511, 1023, 2047, 100, 1000)
K12_TIMED = (2047, 255)
K12_GRAPH_LAUNCHES = 20
# no JAX solver calls the row-grouped sweep, so no path of the port does:
# its launches are those of its parity phase
OFF_PATH = {"fused_gs4_sweep_rm": "no JAX solver calls it"}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, ref) -> tuple[float, float]:
    d = float((got.double() - ref.double()).abs().max())
    return d, d / max(float(ref.double().abs().max()), 1e-300)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for moving nbytes and doing
    ops f32 operations at the data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_ops(w33, cells: int, symmetric: bool = True) -> int:
    """f32 operations of one GS sweep: per cell update a multiply and an
    add per nonzero off-diagonal weight, then 5 (b - acc, * inv_diag,
    - u, * omega, + u); each cell updates twice when symmetric."""
    k = sum(1 for dj in range(3) for di in range(3)
            if (dj, di) != (1, 1) and w33[dj][di] != 0.0)
    return cells * (2 if symmetric else 1) * (2 * k + 5)


def residual_ops(w33, cells: int) -> int:
    """f32 operations of a residual b - A u: a multiply and an add per
    nonzero off-diagonal weight, the centre product, its add and b - acc."""
    k = sum(1 for dj in range(3) for di in range(3)
            if (dj, di) != (1, 1) and w33[dj][di] != 0.0)
    return cells * (2 * k + 3)


def packed_fields(side: int, seed: int, dev):
    m = (side - 1) // 2
    rng = np.random.default_rng(seed)

    def f(scale=1.0):
        x = rng.standard_normal((side, side)) * scale
        return pack(torch.as_tensor(x, dtype=torch.float32, device=dev), m)
    return m, f


def sync() -> None:
    """Wait for the card: in a thread of a card group for this thread's
    stream only (a wait for the whole card could wait for the other
    block's K7 launch, which waits for this thread's next one), else for
    the card."""
    if launch.in_card_group():
        torch.cuda.current_stream().synchronize()
    else:
        torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, CUDA events."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / reps


def alternating(fa, fb, reps_a: int, reps_b: int | None = None
                ) -> tuple[float, float]:
    """a, b, b, a: the better of two runs of each, in ms."""
    reps_b = reps_a if reps_b is None else reps_b
    a1 = time_ms(fa, reps_a)
    b1 = time_ms(fb, reps_b)
    b2 = time_ms(fb, reps_b)
    a2 = time_ms(fa, reps_a)
    return min(a1, a2), min(b1, b2)


def interleaved(name: str, size: str, kern, plain, reps: int, times: dict):
    """plain, kernel, kernel, plain: the better of two runs of each,
    compared within one call."""
    pms, kms = alternating(plain, kern, max(reps // 5, 2), reps)
    print(f"time {name} {size}: kernel {kms:.4f} ms, plain {pms:.4f} ms "
          f"(x{pms / kms:.1f})")
    times[name] = (kms, pms)


def parity_and_timing(dev):
    """Phases 2 and 3 for K4 (K1, K2, K3: windowed_parity_and_timing): the
    kernel against its plain version at PARITY_SIDES (r.hi bitwise, pad
    cells exactly 0, the rss within BOUND["df_rss"] and the same bits on a
    repeated call), and both timed at DF_TIMED. Returns max_abs_err,
    {kernel: (kernel ms, plain ms)} and {kernel: bound} at M = 2048, and
    {kernel: {M: (ms, bound ms)}}."""
    name = "fused_df_residual_rss"
    errs = {name: 0.0}
    times, bounds, by_m = {}, {}, {name: {}}
    for side in PARITY_SIDES:
        M = (side + 1) // 2
        w33 = poisson_const_w33(side, 1)[0]
        if not is_pow2_weights(w33):   # the ragged sides are not 2^k - 1
            w33 = ((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0))
        m, f = packed_fields(side, seed=side, dev=dev)
        u_df, b_df = DF32(hi=f(), lo=f(1e-8)), DF32(hi=f(), lo=f(1e-8))

        rh, rss = K.fused_df_residual_rss(w33, b_df, u_df, m)
        rh_ref, rss_ref = df_residual_rss_plain(w33, b_df, u_df, m)
        rh2, rss2 = K.fused_df_residual_rss(w33, b_df, u_df, m)
        d, _ = rel_err(rh, rh_ref)
        same = torch.equal(rh, rh_ref)
        rss_rel = abs(float(rss) - float(rss_ref)) / float(rss_ref)
        again = torch.equal(rh2, rh) and torch.equal(rss2, rss)
        errs[name] = max(errs[name], d)
        print(f"parity K4 df residual M={M}: r.hi bitwise equal {same} "
              f"(max_abs {d:.3e}); rss {float(rss):.17e} against "
              f"{float(rss_ref):.17e}, rel {rss_rel:.3e} (bound "
              f"{BOUND['df_rss']}); repeated call same bits {again}")
        require(same, f"K4 r.hi bitwise equal to its plain version (M={M})")
        require(rss_rel <= BOUND["df_rss"], f"K4 rss within bound (M={M})")
        require(again, f"K4 reproducible (M={M})")
        require(pads_zero(rh, m), f"K4 pad cells exactly 0 (M={M})")
        if side not in DF_TIMED:
            continue
        t = {}
        interleaved(name, f"M={M}",
                    lambda: K.fused_df_residual_rss(w33, b_df, u_df, m),
                    lambda: df_residual_rss_plain(w33, b_df, u_df, m),
                    50 if M <= 512 else 20, t)
        # b.hi, b.lo, u.hi, u.lo read, r.hi and the f64 rss written; 5
        # TwoSum-cascade terms of 10 ops, a TwoSum, the square
        bnd = bound(5 * u_df.hi.nbytes + 8, 60 * side * side)
        by_m[name][M] = (t[name][0], bnd[0])
        if M == 2048:
            times.update(t)
            bounds[name] = bnd
        del u_df, b_df, rh, rh_ref, rh2
    return errs, times, bounds, by_m


def down_leg_bound(w33, side: int, f4: int) -> tuple[float, str]:
    """K2's least time: u and b read, u and the (M, M) bc_pad written; the
    sweep, the residual (2k + 3 ops a cell) and the restriction (4)."""
    cells = side * side
    return bound(3 * f4 + f4 // 4, sweep_ops(w33, cells)
                 + residual_ops(w33, cells) + 4 * cells)


def pads_zero(u4: torch.Tensor, m: int) -> bool:
    """The pad cells of a packed field are exactly 0."""
    return (float(u4[1][:, m].abs().max()) == float(u4[2][m, :].abs().max())
            == float(u4[3][m, :].abs().max())
            == float(u4[3][:, m].abs().max()) == 0.0)


def windowed_parity_and_timing(dev):
    """K1, K2 and K3 against their plain versions at WINDOW_SIDES, bitwise
    (torch.equal) on every output, symmetric and forward, omega 0.9 and 1,
    pad cells (K2: bc_pad's pad row and column) exactly 0, on the 5-point
    Poisson weights and WINDOW_WEIGHTS; each timed against its plain
    version at WINDOW_TIMED (Poisson; 9-point beside it) beside its bound.
    Returns max_abs_err per kernel, the times at M = 2048, the bounds
    there and {kernel: {M: (kernel ms, bound ms)}}."""
    names = ("fused_gs4_sweep_packed", "fused_down_leg_packed",
             "fused_up_leg_packed")
    errs = {k: 0.0 for k in names}
    times, bounds, by_m = {}, {}, {k: {} for k in names}
    for side in WINDOW_SIDES:
        M = (side + 1) // 2
        w33 = poisson_const_w33(side, 1)[0]
        m, f = packed_fields(side, seed=side + 3, dev=dev)
        u4, b4 = f(), f()
        uc_pad = F.pad(f()[0, :m, :m], (0, 1, 0, 1))

        def calls(w, omega=1.0, symmetric=True):
            """{kernel: (kernel call, plain call)} on these fields."""
            return {
                "fused_gs4_sweep_packed": (
                    lambda: K.fused_gs4_sweep_packed(u4, b4, w, m, omega,
                                                     symmetric),
                    lambda: gs4_sweep_packed(u4, b4, w, m, omega,
                                             symmetric)),
                "fused_down_leg_packed": (
                    lambda: K.fused_down_leg_packed(u4, b4, w, m, omega,
                                                    symmetric),
                    lambda: down_leg_plain(u4, b4, w, m, omega, symmetric)),
                "fused_up_leg_packed": (
                    lambda: K.fused_up_leg_packed(u4, b4, uc_pad, w, m,
                                                  omega, symmetric),
                    lambda: up_leg_plain(u4, b4, uc_pad, w, m, omega,
                                         symmetric))}

        for label, w in (("five", w33), *WINDOW_WEIGHTS.items()):
            for symmetric in (True, False):
                for omega in (0.9, 1.0):
                    for name, (kern, plain) in calls(w, omega,
                                                     symmetric).items():
                        got, ref = kern(), plain()
                        if name == "fused_down_leg_packed":
                            (gu, gbc), (ru, rbc) = got, ref
                            du, r_u = rel_err(gu, ru)
                            dbc, r_bc = rel_err(gbc, rbc)
                            same = (torch.equal(gu, ru)
                                    and torch.equal(gbc, rbc))
                            pads = (float(gbc[m, :].abs().max()) == 0.0
                                    and float(gbc[:, m].abs().max()) == 0.0)
                            errs[name] = max(errs[name], du, dbc)
                            what = (f"u max_abs {du:.3e} rel {r_u:.3e}, bc "
                                    f"max_abs {dbc:.3e} rel {r_bc:.3e}")
                            kid = "K2 down leg"
                        else:
                            d, r = rel_err(got, ref)
                            same = torch.equal(got, ref)
                            pads = pads_zero(got, m)
                            errs[name] = max(errs[name], d)
                            what = f"max_abs {d:.3e} rel {r:.3e}"
                            kid = ("K1 sweep" if name == names[0]
                                   else "K3 up leg")
                        print(f"parity {kid} M={M} {label}-point "
                              f"symmetric={symmetric} omega={omega}: {what}; "
                              f"bitwise equal {same}")
                        require(same, f"{kid} bitwise equal to its plain "
                                "version")
                        require(pads, f"{kid} pad cells exactly 0")
        if side in WINDOW_TIMED:
            f4, cells = u4.nbytes, side * side
            sweep = sweep_ops(w33, cells)
            bnds = {"fused_gs4_sweep_packed": bound(3 * f4, sweep),
                    "fused_down_leg_packed": down_leg_bound(w33, side, f4),
                    # the prolongation's 3 ops a cell
                    "fused_up_leg_packed": bound(3 * f4 + uc_pad.nbytes,
                                                 sweep + 3 * cells)}
            nine = calls(WINDOW_WEIGHTS["nine"])
            t = {}
            for name, (kern, plain) in calls(w33).items():
                kern9 = nine[name][0]
                t9 = min(time_ms(kern9, 20), time_ms(kern9, 20))
                interleaved(name, f"M={M}", kern, plain,
                            50 if M <= 512 else 20, t)
                bnd = bnds[name]
                by_m[name][M] = (t[name][0], bnd[0])
                print(f"time {name} M={M}: {t[name][0]:.4f} ms against its "
                      f"bound {bnd[0]:.4f} ms ({bnd[1]}), "
                      f"{bnd[0] / t[name][0]:.1%}; 9-point weights "
                      f"{t9:.4f} ms")
            if M == 2048:
                times.update(t)
                bounds.update(bnds)
        del u4, b4, uc_pad
    return errs, times, bounds, by_m


def rbgs_parity_and_timing(dev):
    """K5/K6 bitwise against their plain version at RBGS_SIDES: symmetric
    and forward, omega 1 and 0.9; K5 on the Poisson and on 9-point weights,
    K6 on the jump-coefficient planes and on random positive planes. Times
    both at n = 4095 (the path's size), K5 on Poisson and K6 on the jump
    planes, and K5 also at n = 1023; returns K5's {n: (ms, bound ms)}
    too."""
    errs = {"fused_gs4_sweep_const": 0.0, "fused_gs4_sweep_var": 0.0}
    times, bounds, k5_by_n = {}, {}, {}
    for side in RBGS_SIDES:
        g = torch.Generator(device=dev).manual_seed(side)
        u = torch.randn((side, side), generator=g, device=dev)
        b = torch.randn((side, side), generator=g, device=dev)
        rand = torch.rand((3, 3, side, side), generator=g, device=dev) + 0.5
        rand[1, 1] += 8.0
        w33 = poisson_const_w33(side, 1)[0]
        ops = {"K5 poisson": Stencil2D.const(w33, side),
               "K5 nine": Stencil2D.const(WINDOW_WEIGHTS["nine"], side),
               "K6 jump": Stencil2D(side=side, c=varcoef.jump_planes(
                   side, device=dev)),
               "K6 random": Stencil2D(side=side, c=rand)}
        for label, S in ops.items():
            name = ("fused_gs4_sweep_const" if S.w33 is not None
                    else "fused_gs4_sweep_var")
            for symmetric in (True, False):
                for omega in (1.0, 0.9):
                    got = K.fused_gs4_sweep(S, u, b, omega, symmetric)
                    ref = fused_gs4_sweep_plain(S, u, b, omega, symmetric)
                    d, r = rel_err(got, ref)
                    same = torch.equal(got, ref)
                    errs[name] = max(errs[name], d)
                    print(f"parity {label} n={side} symmetric={symmetric} "
                          f"omega={omega}: max_abs {d:.3e} rel {r:.3e}, "
                          f"bitwise equal {same}")
                    require(same, f"{label} bitwise equal to its plain "
                            f"version (n={side}, symmetric={symmetric}, "
                            f"omega={omega})")
        cells = side * side
        k5_bound = bound(3 * u.nbytes, sweep_ops(w33, cells))
        if side == 1023:
            t = {}
            S = ops["K5 poisson"]
            interleaved("fused_gs4_sweep_const", f"n={side}",
                        lambda: K.fused_gs4_sweep(S, u, b),
                        lambda: fused_gs4_sweep_plain(S, u, b), 50, t)
            k5_by_n[side] = (t["fused_gs4_sweep_const"][0], k5_bound[0])
        if side == 4095:
            for label, name in (("K5 poisson", "fused_gs4_sweep_const"),
                                ("K6 jump", "fused_gs4_sweep_var")):
                S = ops[label]
                interleaved(name, f"n={side}",
                            lambda: K.fused_gs4_sweep(S, u, b),
                            lambda: fused_gs4_sweep_plain(S, u, b), 20,
                            times)
            bounds["fused_gs4_sweep_const"] = k5_bound
            k5_by_n[side] = (times["fused_gs4_sweep_const"][0], k5_bound[0])
            # 8 off-diagonal terms and a division per update
            bounds["fused_gs4_sweep_var"] = bound(
                3 * u.nbytes + ops["K6 jump"].c.nbytes, cells * 2 * 22)
        del ops, rand
    return errs, times, bounds, k5_by_n


def split_parity_and_timing(dev):
    """K8 against its plain version at K8_SIDES (M = 101 and 4096),
    bitwise on 5- and 9-point weights, bc_pad's pad row and column exactly
    0, and timed against it at M = 4096. Returns max_abs_err, the times and
    the bound."""
    name = "fused_residual_restrict_packed"
    errs, times, bounds = {name: 0.0}, {}, {}
    for side in K8_SIDES:
        M = (side + 1) // 2
        w33 = poisson_const_w33(side, 1)[0]
        m, f = packed_fields(side, seed=side + 2, dev=dev)
        u4, b4 = f(), f()
        for wname, w in (("five", w33), ("nine", WINDOW_WEIGHTS["nine"])):
            got = K.fused_residual_restrict_packed(u4, b4, w, m)
            ref = residual_restrict_plain(u4, b4, w, m)
            d, r = rel_err(got, ref)
            same = torch.equal(got, ref)
            errs[name] = max(errs[name], d)
            print(f"parity K8 residual+restrict M={M} {wname}: max_abs "
                  f"{d:.3e} rel {r:.3e}, bitwise equal {same}")
            require(same, f"K8 bitwise equal to its plain version (M={M}, "
                    f"{wname})")
            require(float(got[m, :].abs().max()) == 0.0
                    and float(got[:, m].abs().max()) == 0.0,
                    "K8 bc_pad pad row and column exactly 0")
        if M == 4096:
            interleaved(name, f"M={M}",
                        lambda: K.fused_residual_restrict_packed(
                            u4, b4, w33, m),
                        lambda: residual_restrict_plain(u4, b4, w33, m), 20,
                        times)
            # u and b read, the (M, M) bc_pad written; the restriction's
            # 4 ops a cell as in the down leg's bound
            f4, cells = u4.nbytes, side * side
            bounds[name] = bound(2 * f4 + f4 // 4,
                                 residual_ops(w33, cells) + 4 * cells)
        del u4, b4, got, ref
    return errs, times, bounds


def rm_parity_and_timing(dev):
    """K9 against its plain version and, through to_rm / from_rm, against
    K1 on the same fields at K9_SIDES (M = 101, 512, 2048, 4096), bitwise,
    on the 5-point Poisson weights and WINDOW_WEIGHTS, symmetric and
    forward, omega 0.9 and 1, pad cells exactly 0. At K9_TIMED it is timed
    against its plain version and in turns with K1 beside its bound; at
    M = 4096 also to_rm + from_rm alone (does the row-grouped layout pay
    for its conversions on the card?). Returns max_abs_err, the times and
    bound at M = 4096, {M: (ms, bound ms)} and K9's launches here."""
    name = "fused_gs4_sweep_rm"
    err, times, bounds, by_m, launches = 0.0, {}, {}, {}, 0
    for side in K9_SIDES:
        M = (side + 1) // 2
        w33 = poisson_const_w33(side, 1)[0]
        m, f = packed_fields(side, seed=side + 5, dev=dev)
        u4, b4 = f(), f()
        u_rm, b_rm = to_rm(u4), to_rm(b4)
        for label, w in (("five", w33), *WINDOW_WEIGHTS.items()):
            for symmetric in (True, False):
                for omega in (0.9, 1.0):
                    n0 = K.fused_gs4_sweep_rm.launches
                    got = K.fused_gs4_sweep_rm(u_rm, b_rm, w, m, omega,
                                               symmetric)
                    launches += K.fused_gs4_sweep_rm.launches - n0
                    ref = fused_gs4_sweep_rm_plain(u_rm, b_rm, w, m, omega,
                                                   symmetric)
                    k1 = K.fused_gs4_sweep_packed(u4, b4, w, m, omega,
                                                  symmetric)
                    d, _ = rel_err(got, ref)
                    g4 = from_rm(got)
                    same = torch.equal(got, ref)
                    same_k1 = torch.equal(g4, k1)
                    err = max(err, d)
                    print(f"parity K9 rm sweep M={M} {label}-point "
                          f"symmetric={symmetric} omega={omega}: max_abs "
                          f"{d:.3e}; bitwise equal {same}, to K1 through "
                          f"from_rm {same_k1}")
                    require(same and same_k1, "K9 bitwise equal to its "
                            "plain version and to K1")
                    require(pads_zero(g4, m), "K9 pad cells exactly 0")
        if side in K9_TIMED:
            t = {}
            interleaved(name, f"M={M}",
                        lambda: K.fused_gs4_sweep_rm(u_rm, b_rm, w33, m),
                        lambda: fused_gs4_sweep_rm_plain(u_rm, b_rm, w33, m),
                        20, t)
            k1_ms, k9_ms = alternating(
                lambda: K.fused_gs4_sweep_packed(u4, b4, w33, m),
                lambda: K.fused_gs4_sweep_rm(u_rm, b_rm, w33, m), 20)
            bnd = bound(3 * u4.nbytes, sweep_ops(w33, side * side))
            by_m[M] = (t[name][0], bnd[0])
            print(f"time K9 against K1 M={M}: K9 {k9_ms:.4f} ms, K1 "
                  f"{k1_ms:.4f} ms (K9/K1 {k9_ms / k1_ms:.3f}); K9 against "
                  f"its bound {bnd[0]:.4f} ms ({bnd[1]}), "
                  f"{bnd[0] / k9_ms:.1%}")
            if M == 4096:
                times.update(t)
                bounds[name] = bnd
                conv_ms = min(time_ms(lambda: from_rm(to_rm(u4)), 10),
                              time_ms(lambda: from_rm(to_rm(u4)), 10))
                print(f"time to_rm + from_rm M={M}: {conv_ms:.4f} ms a "
                      f"field; a solve that kept its state row-grouped "
                      f"would convert u and b once each way "
                      f"({2 * conv_ms:.4f} ms) and gain "
                      f"{k1_ms - k9_ms:.4f} ms a sweep")
        del u4, b4, u_rm, b_rm, got, ref, k1
    return {name: err}, times, bounds, {name: by_m}, launches


def f64_rss(u: torch.Tensor, b: torch.Tensor, side: int) -> float:
    """Independent rss of b - A u: plain f64 5-point Laplacian (-4/h^2
    diagonal, +1/h^2 neighbours, zero Dirichlet boundary)."""
    h = poisson.grid_spacing_h(side)
    up = F.pad(u, (1, 1, 1, 1))
    Au = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
          - 4.0 * u) / (h * h)
    return float(torch.sum((b - Au) ** 2))


def f64_rss_planes(u: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                   ) -> float:
    """Independent rss of b - A u for (3,3,n,n) planes, in f64 with its
    own 9 shifted products (zero Dirichlet boundary)."""
    n = u.shape[0]
    up = F.pad(u, (1, 1, 1, 1))
    Au = torch.zeros_like(u)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            Au += (c[dj + 1, di + 1].double()
                   * up[1 + dj:1 + dj + n, 1 + di:1 + di + n])
    return float(torch.sum((b - Au) ** 2))


def solution_bound(rss1: float, rss2: float, side: int) -> float:
    """Bound on max|u1 - u2| for two iterates of the same system:
    |u1 - u2|_max <= |A^-1|_2 (|r1|_2 + |r2|_2), |A^-1|_2 = 1/lambda_min
    with lambda_min = 8 sin^2(pi h / 4) / h^2 (about pi^2 / 2) for the
    Poisson operator, and at most that for the jump operator (a >= 1)."""
    h = poisson.grid_spacing_h(side)
    lam_min = 8.0 * np.sin(np.pi * h / 4.0) ** 2 / (h * h)
    return (rss1 ** 0.5 + rss2 ** 0.5) / lam_min


def solve_once(s: StructuredSolver, b2: torch.Tensor):
    """The constant main path: prepare_b -> solve_ir_device_prepared ->
    finalize_u."""
    u4, stats = s.solve_ir_device_prepared(s.prepare_b(b2), tolerance=TOL)
    u = s.finalize_u(u4)
    err, it = stats.tolist()
    return u, err, int(it)


def solve_device(s: StructuredSolver, b2, tol: float, n_refine: int = 40):
    u, stats = s.solve_ir_device(b2, tolerance=tol, n_refine=n_refine)
    err, it = stats.tolist()
    return u, err, int(it)


def drive(fn, launches: dict):
    """One run of a path with the launch counts set to 0 just before it
    and read just after; adds them to ``launches``."""
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for k, n in counts.items():
        launches[k] += n
    return out, counts


def wall_median(fn, reps: int) -> tuple[float, list]:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def const_solves(dev, launches: dict):
    """Phase 4: the constant Poisson solve at 1023^2 and 4095^2 (legs),
    and at 1023^2 with two sweeps (K1)."""
    configs = [(side, 1) for side in SOLVE_SIDES] + [(1023, 2)]
    solvers, rhs = {}, {}
    for side, sweeps in configs:
        t0 = time.perf_counter()
        s = StructuredSolver(side, pre_sweeps=sweeps, post_sweeps=sweeps,
                             device=dev)
        s.warmup()
        torch.cuda.synchronize()
        print(f"setup+warmup {side}^2 sweeps={sweeps}: plan {s.plan}, "
              f"{time.perf_counter() - t0:.2f} s")
        solvers[(side, sweeps)] = s
        rhs[side] = poisson.rhs(side, device=dev).reshape(side, side)

    results = {}
    for side, sweeps in configs:
        (u, err, it), c = drive(
            lambda: solve_once(solvers[(side, sweeps)], rhs[side]), launches)
        results[(side, sweeps)] = (u, err, it)
        ind = f64_rss(u, rhs[side], side)
        print(f"solve {side}^2 sweeps={sweeps}: refines {it}, rss "
              f"{err:.6e}, independent f64 rss {ind:.6e}, launches {c}")
        require(bool(torch.isfinite(u).all()) and u.shape == (side, side),
                f"finite u of shape ({side}, {side})")
        require(err <= TOL and ind <= TOL, f"{side}^2 converged to {TOL}")
        require(c["fused_df_residual_rss"] == it + 1, "K4 = it + 1")
        require(c[LOOP] == loop_conditions(it, packed=True),
                "one loop graph: the condition at the start, each pass "
                "and the final branch")
        # visits of the plan's n fused levels: the FMG start's V-cycle
        # from each of them, then 3 a refine from the fine one
        n = solvers[(side, sweeps)].plan.count(
            "legs" if sweeps == 1 else "sweep")
        visits = n * (n + 1) // 2 + 3 * n * it
        if sweeps == 1:
            require(c["fused_down_leg_packed"] == visits
                    and c["fused_up_leg_packed"] == visits,
                    f"K2 = K3 = {visits} at {side}^2")
            require(c["fused_gs4_sweep_packed"] == 0, "K1 off the legs path")
        else:
            require(c["fused_gs4_sweep_packed"] == 4 * visits,
                    f"K1 = 4 x {visits} with two sweeps")
            require(c["fused_down_leg_packed"] == 0, "legs off at 2 sweeps")
        require(c["fused_gs4_sweep_const"] == c["fused_gs4_sweep_var"] == 0,
                "K5/K6 off the packed path")

    for side in SOLVE_SIDES:
        med, walls = wall_median(
            lambda: solve_once(solvers[(side, 1)], rhs[side]), 5)
        print(f"solve wall {side}^2: median of 5 {med:.6f} s (all {walls})")
        RECORD[f"const wall {side}"] = med

    # the card's solve against the port's own CPU solve, 1023^2
    u_gpu, _, it_gpu = results[(1023, 1)]
    b_cpu = poisson.rhs(1023, device="cpu").reshape(1023, 1023)
    u_cpu, _, it_cpu = solve_once(StructuredSolver(1023, device="cpu"),
                                  b_cpu)
    du = float((u_gpu.cpu() - u_cpu).abs().max())
    bnd = solution_bound(f64_rss(u_gpu.cpu(), b_cpu, 1023),
                         f64_rss(u_cpu, b_cpu, 1023), 1023)
    print(f"gpu vs cpu 1023^2: refines {it_gpu} / {it_cpu}, max|du| "
          f"{du:.3e} (bound {bnd:.3e})")
    require(it_gpu == it_cpu, "same refine count on GPU and CPU")
    require(du <= bnd, "GPU and CPU solutions within the residual bound")


def level_sides(side: int) -> list:
    """The sides of the hierarchy of ``side`` (1023: 9 levels down to 3)."""
    sides = [side]
    while len(sides) < max_levels_for_side(side):
        sides.append((sides[-1] - 1) // 2)
    return sides


def native_checks(dev, launches: dict):
    """The native setup engine (amg_tpu_torch/native; host C++, no
    kernel): built and loaded, so no run falls back to scipy unnoticed;
    the Galerkin chain at NATIVE_RAP_SIDE^2 native against scipy's
    (galerkin_chain) within NATIVE_RAP_RTOL of each level's largest
    entry; the native coloring of the chain's 1023^2 level against the
    Python loop, equal colors; bench.py's C++ baseline (cpu_vcycle_solve
    on the native chain, best of BASELINE_RUNS) at BASELINE_SIDE^2 to TOL,
    beside the port's constant solve wall there (const_solves) as
    vs_baseline = baseline / port. Each step timed."""
    t0 = time.perf_counter()
    built = bindings.available()
    require(built, f"the native engine builds and loads: "
            f"{bindings.last_error()}")
    print(f"native engine: g++ build + load {time.perf_counter() - t0:.3f} "
          f"s ({bindings.CXX_FLAGS})")
    side = NATIVE_RAP_SIDE
    sides = level_sides(side)
    A = poisson.laplacian_scipy(side)
    chains, secs = {}, {}
    for native in (True, False):
        t0 = time.perf_counter()
        chains[native] = galerkin_chain(A, sides, native=native)
        secs[native] = time.perf_counter() - t0
    worst = max(abs(n - c).max() / abs(c).max()
                for n, c in zip(chains[True], chains[False]))
    print(f"native RAP chain {side}^2 ({len(sides)} levels): native "
          f"{secs[True]:.3f} s, scipy {secs[False]:.3f} s; largest "
          f"difference {worst:.3e} of a level's largest entry")
    require(worst <= NATIVE_RAP_RTOL,
            f"native chain within {NATIVE_RAP_RTOL:g} of scipy's")
    lev = ELL.from_scipy(chains[True][1], dtype=torch.float64, device="cpu")
    cols, data, n = lev.cols.numpy(), lev.data.numpy(), lev.n_rows
    t0 = time.perf_counter()
    got = bindings.greedy_coloring_native(cols, data, n)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = greedy_coloring_loop(cols, data, n)
    t_loop = time.perf_counter() - t0
    print(f"native coloring {sides[1]}^2 level ({n} rows, K "
          f"{lev.row_width}): native {t_native:.4f} s, Python loop "
          f"{t_loop:.4f} s, {int(got.max()) + 1} colors, equal "
          f"{np.array_equal(got, loop)}")
    require(np.array_equal(got, loop), "native colors are the loop's")
    del chains, lev

    side = BASELINE_SIDE
    sides = level_sides(side)
    t0 = time.perf_counter()
    mats, Ps, Rs = [poisson.laplacian_scipy(side)], [], []
    for l in range(len(sides) - 1):
        P2 = sp.kron(*[linear_interp_1d(sides[l], sides[l + 1])] * 2).tocsr()
        Ps.append(P2)
        Rs.append(bindings.csr_transpose(P2))
        mats.append(bindings.galerkin_rap(Rs[-1], mats[-1], P2))
    setup = time.perf_counter() - t0
    b = poisson.rhs(side, device="cpu").numpy()
    runs = [bindings.cpu_vcycle_solve(mats, Ps, Rs, b, tol=TOL,
                                      check_every=1, max_iters=100)
            for _ in range(BASELINE_RUNS)]
    best, iters, rss, _ = min(runs, key=lambda r: r[0])
    port = RECORD[f"const wall {side}"]
    print(f"C++ baseline {side}^2 (cpu_vcycle_solve, one thread, {len(mats)} "
          f"levels, native setup {setup:.3f} s): best of {BASELINE_RUNS} "
          f"{best:.6f} s (all {[r[0] for r in runs]}), V-cycles {iters}, rss "
          f"{rss:.6e}; the port's constant {side}^2 solve wall {port:.6f} s:"
          f" vs_baseline {best / port:.3f}")
    require(rss <= TOL and all(r[1] == iters for r in runs),
            f"the C++ baseline converges to {TOL}")
    RECORD["vs_baseline"] = best / port


def vcycle_launches(plan: tuple, start: int) -> Counter:
    """Kernel launches of one packed V-cycle from level ``start``, read off
    the plan: a legs level runs K2 and K3, a split level K1, K8 and K3;
    the first masked_legs level K10 and K11 for itself and every level
    below; packed and direct levels no kernel."""
    per_kind = {"legs": ("fused_down_leg_packed", "fused_up_leg_packed"),
                "split": ("fused_gs4_sweep_packed",
                          "fused_residual_restrict_packed",
                          "fused_up_leg_packed")}
    c = Counter(k for kind in plan[start:] for k in per_kind.get(kind, ()))
    if "masked_legs" in plan[start:]:
        c.update(MASKED_LEGS)
    return c


def loop_conditions(it: int, packed: bool = False,
                    converged: bool = True) -> int:
    """Condition-kernel launches of one loop-graph solve of ``it`` refines
    (or PCG iterations): the start, one a pass, and on the packed loop the
    final branch; its passes are ``it``, and one more, residual only, when
    it converged."""
    if not packed:
        return 1 + it
    return 1 + it + int(converged) + 1


def tpu_counts(c: dict) -> dict:
    """The TPU kernels' counts of a launch count dict: K1-K9 (not the
    condition kernel, not the masked legs K10/K11, not the masked sweep
    on planes K12)."""
    return {k: n for k, n in off_masked(c).items() if k != LOOP}


def off_masked(c: dict) -> dict:
    """A launch count dict without the kernels of the plan's masked kinds,
    the masked legs K10/K11 (``masked_legs``) and the masked sweep on
    planes K12 (``masked_k12``), which a hierarchy's kinds name wherever
    its cycles reach such levels (constant ones, plane ones)."""
    return {k: n for k, n in c.items()
            if k not in MASKED_LEGS and k != MASKED_SWEEP}


def k12_launches(s: StructuredSolver, it: int) -> int:
    """K12's launches in a solve of ``it`` refines: a sweep a pre- and a
    post-smoothing of each visit of a ``masked_k12`` level, in the FMG
    start's unpacked cycles (one from each level down, the hierarchy's
    kinds) and in the refines' V-cycles (the plan's)."""
    kinds = s.hier.kinds
    fmg = sum(kinds[k] == "masked_k12" for l in range(len(kinds))
              for k in range(l, len(kinds)))
    cyc = s.plan.count("masked_k12")
    return (s.pre_sweeps + s.post_sweeps) * (
        int(s.fmg) * fmg + s.cycles_per_refine * it * cyc)


def solve_launches(plan: tuple, sides: tuple, it: int,
                   fmg: bool = True) -> Counter:
    """Launches of one packed df32 solve of ``it`` refines: the FMG start
    (fmg=True) runs one V-cycle from each packed level below the fine one,
    then the fine V-cycle; then 3 per refine; K4 once per refine and once
    more; the loop graph's condition (loop_conditions, converged)."""
    c = Counter()
    if fmg:
        for l in range(1, len(sides) - 1):
            c.update(vcycle_launches(plan, l) if sides[l] >= PACKED_MIN_SIDE
                     else MASKED_LEGS)
    for k, n in vcycle_launches(plan, 0).items():
        c[k] += n * (int(fmg) + 3 * it)
    c["fused_df_residual_rss"] = it + 1
    c[LOOP] = loop_conditions(it, packed=True)
    return c


def split_solve(dev, launches: dict):
    """The constant 8191^2 solve, fine level split: plan, launch counts
    against the plan, independent f64 rss, wall; then one V-cycle with the
    split fine level against one with legs (K2/K3) there."""
    side = SPLIT_SIDE
    t0 = time.perf_counter()
    s = StructuredSolver(side, device=dev)
    s.warmup()
    torch.cuda.synchronize()
    print(f"setup+warmup {side}^2: plan {s.plan}, "
          f"{time.perf_counter() - t0:.2f} s")
    require(s.plan[:7] == ("split",) + ("legs",) * 5 + ("masked_legs",),
            f"{side}^2 plan: split, 5 legs, masked legs")
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    (u, err, it), c = drive(lambda: solve_once(s, b2), launches)
    ind = f64_rss(u, b2, side)
    print(f"solve {side}^2: refines {it}, rss {err:.6e}, independent f64 "
          f"rss {ind:.6e}, launches {c}")
    require(bool(torch.isfinite(u).all()) and u.shape == (side, side),
            f"finite u of shape ({side}, {side})")
    require(err <= TOL and ind <= TOL, f"{side}^2 converged to {TOL}")
    # for this plan: K1 = K8 = 1 + 3 it, K2 = 20 + 15 it, K3 = 21 + 18 it,
    # K4 = it + 1
    want = solve_launches(s.plan, s.hier.sides, it)
    require(all(c[k] == want[k] for k in c),
            f"{side}^2 launches equal the plan's: {dict(want)}")
    del u
    med, walls = wall_median(lambda: solve_once(s, b2), 3)
    print(f"solve wall {side}^2: median of 3 {med:.6f} s (all {walls})")

    b32 = b2.to(torch.float32)
    legs = ("legs",) + s.plan[1:]
    cycles, us = {}, {}
    for name, plan in (("split", s.plan), ("legs", legs)):
        def cycle(plan=plan):
            return vcycle_packed(s.hier, torch.zeros_like(b32), b32,
                                 fused=True, plan=plan)
        us[name], c = drive(cycle, launches)
        want = vcycle_launches(plan, 0)
        require(all(c[k] == want[k] for k in c),
                f"{name} V-cycle launches {dict(want)}")
        cycles[name] = cycle
    d, r = rel_err(us["split"], us["legs"])
    split_ms, legs_ms = alternating(cycles["split"], cycles["legs"], 5)
    print(f"vcycle {side}^2 split vs legs: max_abs {d:.3e} rel {r:.3e} "
          f"(bound 1e-5), bitwise equal "
          f"{torch.equal(us['split'], us['legs'])}; event ms per V-cycle "
          f"split {split_ms:.4f}, legs {legs_ms:.4f}")
    require(r <= 1e-5, "split and legs V-cycles agree")
    # the fine level's down half alone: K1 + K8 against K2, M = 4096
    m = s.m
    w33 = s.hier.w33s[0]
    u4 = pack(us["split"], m)
    b4 = pack(b32, m)

    def split_down():
        return K.fused_residual_restrict_packed(
            K.fused_gs4_sweep_packed(u4, b4, w33, m), b4, w33, m)
    sd_ms, k2_ms = alternating(
        split_down, lambda: K.fused_down_leg_packed(u4, b4, w33, m), 10)
    print(f"time down half M={m + 1}: K1 + K8 {sd_ms:.4f} ms, K2 "
          f"{k2_ms:.4f} ms (K2 / (K1 + K8) {k2_ms / sd_ms:.3f})")
    del s, b2, b32, us, u4, b4


def pcg_solves(dev, launches: dict):
    """bench.py's pcg_stats on the card: solve_pcg_device(fused=True) on
    the packed hierarchy, f32, tol 1e-5, at 2047^2 and 4095^2: rss, the
    iterations beside the TPU record's, an independent f64 rss, K2 = K3 =
    legs levels x (it + 1) and no other kernel, the wall; then the card's
    1023^2 PCG against the port's CPU PCG."""
    def pcg(h, b):
        u, stats = solve_pcg_device(h, b, tolerance=PCG_TOL, n_iters=50,
                                    fused=True)
        err, it = stats.tolist()
        return u, err, int(it)

    for side in PCG_SIDES:
        hier = build_stencil_hierarchy_device(side, smoother="packed",
                                              device=dev)
        b2 = poisson.rhs(side, device=dev).reshape(side, side)
        b32 = b2.to(torch.float32)
        pcg(hier, b32)                          # warm the allocator
        (u, err, it), c = drive(lambda: pcg(hier, b32), launches)
        RECORD[f"pcg {side}"] = it
        ind = f64_rss(u.double(), b32.double(), side)
        # what f32 can hold: the df32 solve's u rounded to f32
        u64 = solve_once(StructuredSolver(side, device=dev), b2)[0]
        floor = f64_rss(u64.float().double(), b32.double(), side)
        _, rel_u = rel_err(u, u64)
        legs = level_plan(hier, 1, 1, PACKED_MIN_SIDE, True).count(
            "legs")
        print(f"pcg {side}^2 f32 tol {PCG_TOL:g}: iterations {it} (TPU v5e "
              f"record: {PCG_TPU_ITERS}), recurrence rss {err:.6e}, "
              f"independent f64 rss {ind:.6e} (f32 floor: the df32 "
              f"solution rounded to f32 has {floor:.6e}; max|u - u_df32| / "
              f"max|u_df32| {rel_u:.3e}), launches {c}")
        require(bool(torch.isfinite(u).all()), f"pcg {side}^2: finite u")
        require(err <= PCG_TOL, f"pcg {side}^2 converged to {PCG_TOL:g}")
        # the recurrence rss does not hold the f32 iterate; the df32
        # solution does, well above f32 rounding
        require(rel_u <= PCG_REL_U, f"pcg {side}^2 within {PCG_REL_U:g} "
                "of the df32 solution")
        require(legs == {2047: 4, 4095: 5}[side], "legs levels of the plan")
        require(c["fused_down_leg_packed"] == c["fused_up_leg_packed"]
                == legs * (it + 1),
                f"pcg {side}^2: K2 = K3 = {legs} x (it + 1)")
        require(sum(n for k, n in tpu_counts(c).items() if k not in (
            "fused_down_leg_packed", "fused_up_leg_packed")) == 0,
            f"pcg {side}^2: no other kernel")
        require(c["masked_down_leg"] == c["masked_up_leg"] == it + 1,
                f"pcg {side}^2: K10 = K11 = it + 1 (a V-cycle each)")
        require(c[LOOP] == loop_conditions(it), f"pcg {side}^2: one loop "
                "graph, the condition at the start and each iteration")
        med, walls = wall_median(lambda: pcg(hier, b32), 3)
        print(f"pcg wall {side}^2: median of 3 {med:.6f} s (all {walls})")
        del hier, b2, b32, u, u64

    side = 1023
    b_cpu = poisson.rhs(side, dtype=torch.float32, device="cpu").reshape(
        side, side)
    u_gpu, _, it_gpu = pcg(build_stencil_hierarchy_device(
        side, smoother="packed", device=dev), b_cpu.to(dev))
    u_cpu, _, it_cpu = pcg(build_stencil_hierarchy_device(
        side, smoother="packed", device="cpu"), b_cpu)
    du = float((u_gpu.cpu() - u_cpu).abs().max())
    # the f32 iterates' rss sits at the f32 floor, so a bound from it holds
    # nothing here: hold the difference to f32 summation-order noise
    bnd = PCG_CARD_CPU_REL * float(u_cpu.abs().max())
    print(f"pcg gpu vs cpu {side}^2: iterations {it_gpu} / {it_cpu}, "
          f"max|du| {du:.3e} (bound {PCG_CARD_CPU_REL:g} max|u_cpu| = "
          f"{bnd:.3e})")
    require(it_gpu == it_cpu, "pcg: same iterations on GPU and CPU")
    require(du <= bnd, "pcg GPU and CPU solutions agree")


# (label, side, StructuredSolver options, tolerance, n_refine, the TPU's
# recorded V-cycle count where it has one: BENCH_r05.json var rows)
VAR_ROWS = (
    ("var auto df32", 2047, {}, 1e-7, 40, 21),
    ("var auto df32", 4095, {}, 1e-5, 40, 42),
    ("var fused df32", 4095, {"smoother": "fused"}, 1e-5, 40, None),
    ("var f64", 4095, {"precision": "f64"}, 1e-7, 40, None),
)


def var_solves(dev, launches: dict):
    """Phase 5: the jump-coefficient solve through solve_ir_device, each
    row checked by an independent f64 rss; the constant fused solve (K5);
    the card against the CPU at 255^2."""
    for label, side, kw, tol, n_refine, tpu_cycles in VAR_ROWS:
        t0 = time.perf_counter()
        planes = varcoef.jump_planes(side, a_in=100.0, device=dev)
        s = StructuredSolver(side, A_planes=planes, device=dev, **kw)
        b2 = poisson.rhs(side, device=dev).reshape(side, side)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        s.warmup()                    # the loop graph's capture
        print(f"warmup {label} {side}^2: {time.perf_counter() - t0:.2f} s")
        (u, err, it), c = drive(lambda: solve_device(s, b2, tol, n_refine),
                                launches)
        ind = f64_rss_planes(u, b2, planes)
        cycles = it * s.cycles_per_refine
        tpu = f" (TPU v5e record: {tpu_cycles})" if tpu_cycles else ""
        print(f"solve {label} {side}^2 tol {tol:g}: plan {s.plan}, setup "
              f"{setup:.2f} s, refines {it}, V-cycles {cycles}{tpu}, rss "
              f"{err:.6e}, independent f64 rss {ind:.6e}, launches {c}")
        require(bool(torch.isfinite(u).all()) and u.shape == (side, side),
                f"{label} {side}^2: finite u of shape ({side}, {side})")
        if kw.get("precision") == "f64":
            # open question (b): does native f64 get past the TPU's 1e-6
            # stall at 4095^2? Required: 1e-5; reported: 1e-7 reached or not
            print(f"var f64 {side}^2 reached {tol:g}: {err <= tol} "
                  f"(final rss {err:.6e})")
            require(err <= 1e-5 and ind <= 1e-5, "var f64 rss <= 1e-5")
        else:
            require(err <= tol and ind <= tol,
                    f"{label} {side}^2 converged to {tol:g}")
        fused = kw.get("smoother") == "fused"
        require(c["fused_gs4_sweep_var"] == (2 * (1 + 3 * it) if fused
                                             else 0),
                f"{label}: K6 = 2 (1 + 3 it) on the fused path, else 0")
        require(sum(n for k, n in tpu_counts(c).items()
                    if k != "fused_gs4_sweep_var") == 0,
                f"{label}: no other kernel on a variable operator")
        require(c[MASKED_SWEEP] == k12_launches(s, it) > 0,
                f"{label}: K12 on every masked sweep of a plane level")
        require(c[LOOP] == loop_conditions(it), f"{label}: one loop graph")
        med, walls = wall_median(lambda: solve_device(s, b2, tol, n_refine),
                                 3)
        print(f"solve wall {label} {side}^2: median of 3 {med:.6f} s "
              f"(all {walls})")
        del s, planes

    side = 4095
    s = StructuredSolver(side, smoother="fused", device=dev)
    s.warmup()
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    (u, err, it), c = drive(lambda: solve_device(s, b2, TOL), launches)
    ind = f64_rss(u, b2, side)
    print(f"solve const fused df32 {side}^2: plan {s.plan}, refines {it}, "
          f"rss {err:.6e}, independent f64 rss {ind:.6e}, launches {c}")
    require(err <= TOL and ind <= TOL, f"const fused {side}^2 converged")
    require(c["fused_gs4_sweep_const"] == 2 * (1 + 3 * it),
            "K5 = 2 (1 + 3 it) on the const fused path")
    require(sum(n for k, n in tpu_counts(c).items()
                if k != "fused_gs4_sweep_const") == 0,
            "const fused: no other kernel")
    require(c["masked_down_leg"] == c["masked_up_leg"] > 0,
            "const fused: K10/K11 on the masked levels below 3000^2")
    require(c[MASKED_SWEEP] == 0, "const fused: no K12 on constant levels")
    require(c[LOOP] == loop_conditions(it), "const fused: one loop graph")
    RECORD["fused solver"] = s          # graph_solves' solve_stencil row
    del s

    side = 255
    planes = varcoef.jump_planes(side, a_in=100.0, device="cpu")
    b_cpu = poisson.rhs(side, device="cpu").reshape(side, side)
    u_gpu, _, it_gpu = solve_device(
        StructuredSolver(side, A_planes=planes.to(dev), device=dev),
        b_cpu.to(dev), TOL)
    u_cpu, _, it_cpu = solve_device(
        StructuredSolver(side, A_planes=planes, device="cpu"), b_cpu, TOL)
    du = float((u_gpu.cpu() - u_cpu).abs().max())
    bnd = solution_bound(f64_rss_planes(u_gpu.cpu(), b_cpu, planes),
                         f64_rss_planes(u_cpu, b_cpu, planes), side)
    print(f"gpu vs cpu var {side}^2: refines {it_gpu} / {it_cpu}, max|du| "
          f"{du:.3e} (bound {bnd:.3e})")
    require(it_gpu == it_cpu, "same var refine count on GPU and CPU")
    require(du <= bnd, "var GPU and CPU solutions within the residual bound")


def refine_solves(dev, launches: dict):
    """The constant problem at 4095^2 (legs on 4095 down to 255): the
    host-stepped solve_ir (f64 residual, 3 V-cycles a step, from u = 0;
    the stopping step's cycles run too, as in JAX) and the packed loop
    with fmg=False; refines, rss, an independent f64 rss, launch counts
    from the plan, median wall of 3."""
    side = REFINE_SIDE
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    s = StructuredSolver(side, device=dev)
    s.warmup(refine_step=True)
    res, c = drive(lambda: s.solve_ir(b2, TOL), launches)
    steps = len(res.history)
    ind = f64_rss(res.u, b2, side)
    print(f"solve_ir {side}^2: steps {steps}, refines kept "
          f"{res.iterations // s.cycles_per_refine}, V-cycles "
          f"{res.iterations}, rss {res.error:.6e}, independent f64 rss "
          f"{ind:.6e}, history {res.history}, launches {c}")
    require(bool(torch.isfinite(res.u).all())
            and res.u.shape == (side, side), "solve_ir: finite u")
    require(res.converged and res.error <= TOL and ind <= TOL,
            f"solve_ir {side}^2 converged to {TOL}")
    want = vcycle_launches(s.plan, 0)
    for k in ("fused_down_leg_packed", "fused_up_leg_packed"):
        require(c[k] == want[k] * s.cycles_per_refine * steps,
                f"solve_ir: {k} = legs levels x 3 x steps")
    require(sum(n for k, n in c.items() if k not in want) == 0,
            "solve_ir: no other kernel (its residual is plain f64)")
    med, walls = wall_median(lambda: s.solve_ir(b2, TOL), 3)
    print(f"solve wall solve_ir {side}^2 (a refine graph a step): median "
          f"of 3 {med:.6f} s (all {walls})")
    RECORD["refine solver"] = s         # graph_solves' solve_ir row
    del s

    s = StructuredSolver(side, fmg=False, device=dev)
    s.warmup()
    (u, err, it), c = drive(lambda: solve_once(s, b2), launches)
    ind = f64_rss(u, b2, side)
    print(f"solve fmg=False {side}^2: refines {it} (from the FMG start: "
          f"3), rss {err:.6e}, independent f64 rss {ind:.6e}, launches {c}")
    require(bool(torch.isfinite(u).all()), "fmg=False: finite u")
    require(err <= TOL and ind <= TOL, f"fmg=False {side}^2 converged")
    want = solve_launches(s.plan, s.hier.sides, it, fmg=False)
    require(all(c[k] == want[k] for k in c),
            "fmg=False: K2 = K3 = legs levels x 3 it, K4 = it + 1")
    med, walls = wall_median(lambda: solve_once(s, b2), 3)
    print(f"solve wall fmg=False {side}^2: median of 3 {med:.6f} s "
          f"(all {walls})")
    del s


def smoother_solves(dev, launches: dict):
    """The constant problem at 4095^2 with each unpacked smoother through
    solve_ir_device (the unpacked df32 loop): plain PyTorch on every
    level, as in JAX, but for the masked legs K10/K11 from 127^2 down
    with smoother="masked"; refines, rss, an independent f64 rss, median
    wall of 3."""
    side = REFINE_SIDE
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    for sm in ("masked", "strided", "chebyshev"):
        t0 = time.perf_counter()
        s = StructuredSolver(side, smoother=sm, device=dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        (u, err, it), c = drive(lambda: solve_device(s, b2, TOL), launches)
        ind = f64_rss(u, b2, side)
        print(f"solve smoother={sm} {side}^2: device_setup "
              f"{s.device_setup}, setup {setup:.2f} s, refines {it}, "
              f"V-cycles {it * s.cycles_per_refine}, rss {err:.6e}, "
              f"independent f64 rss {ind:.6e}, launches {c}")
        require(bool(torch.isfinite(u).all()), f"{sm}: finite u")
        require(err <= TOL and ind <= TOL, f"{sm} {side}^2 converged")
        require(sum(tpu_counts(c).values()) == 0, f"{sm}: no kernel")
        legs = c["masked_down_leg"]
        require(c["masked_up_leg"] == legs and (legs > 0) == (sm == "masked"),
                f"{sm}: K10 = K11, on the masked path only")
        require(c[LOOP] == loop_conditions(it), f"{sm}: one loop graph")
        med, walls = wall_median(lambda: solve_device(s, b2, TOL), 3)
        print(f"solve wall smoother={sm} {side}^2: median of 3 {med:.6f} s "
              f"(all {walls})")
        del s


def host_solves(dev, launches: dict):
    """Host-built hierarchies: the jump operator given as a scipy matrix
    (A_fine) at 2047^2 beside the A_planes solve of the same operator;
    then the card against the CPU: solve_stencil on an f64 masked
    hierarchy at 1023^2 to 1e-9 and the free solve_ir at 511^2."""
    side = HOST_JUMP_SIDE
    A = varcoef.jump_scipy(side, a_in=100.0)
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    t0 = time.perf_counter()
    s = StructuredSolver(side, A_fine=A, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    s.warmup()      # the loop graph's capture, whose warm-up runs pieces
    (u, err, it), c = drive(lambda: solve_device(s, b2, TOL), launches)
    r = b2.cpu().numpy().reshape(-1) - A @ u.cpu().numpy().reshape(-1)
    ind = float(r @ r)
    planes = varcoef.jump_planes(side, a_in=100.0, device=dev)
    _, err_p, it_p = solve_device(
        StructuredSolver(side, A_planes=planes, device=dev), b2, TOL)
    print(f"solve jump A_fine {side}^2 (host hierarchy): plan {s.plan}, "
          f"setup {setup:.2f} s, refines {it} (A_planes: {it_p}, rss "
          f"{err_p:.6e}), rss {err:.6e}, independent f64 rss {ind:.6e}, "
          f"launches {c}")
    require(not s.device_setup and s.w33 is None, "A_fine: host build")
    require(err <= TOL and ind <= TOL, f"jump A_fine {side}^2 converged")
    require(sum(tpu_counts(c).values()) == 0, "jump A_fine: no kernel")
    require(c[MASKED_SWEEP] == k12_launches(s, it) > 0,
            "jump A_fine: K12 on the host-built plane levels swept masked")
    require(c[LOOP] == loop_conditions(it), "jump A_fine: one loop graph")
    med, walls = wall_median(lambda: solve_device(s, b2, TOL), 3)
    print(f"solve wall jump A_fine {side}^2: median of 3 {med:.6f} s "
          f"(all {walls})")
    del s, planes

    side = STENCIL_SIDE
    b_cpu = poisson.rhs(side, device="cpu").reshape(side, side)
    runs = {}
    for d in (dev, "cpu"):
        h = build_stencil_hierarchy(side, dtype=torch.float64, device=d)
        runs[str(d)] = solve_stencil(h, b_cpu.to(d), tolerance=1e-9,
                                     device=d)
    rg, rc = runs[str(dev)], runs["cpu"]
    ug = rg.u.cpu()
    du = float((ug - rc.u).abs().max())
    bnd = solution_bound(f64_rss(ug, b_cpu, side),
                         f64_rss(rc.u, b_cpu, side), side)
    print(f"gpu vs cpu solve_stencil f64 masked {side}^2 tol 1e-9: "
          f"V-cycles {rg.iterations} / {rc.iterations}, history "
          f"{rg.history} / {rc.history}, max|du| {du:.3e} (bound {bnd:.3e})")
    require(rg.converged and rc.converged and rg.error <= 1e-9,
            "solve_stencil converged to 1e-9")
    require(f64_rss(ug, b_cpu, side) <= 1e-9, "solve_stencil: independent "
            "f64 rss <= 1e-9")
    require(rg.iterations == rc.iterations
            and [i for i, _ in rg.history] == [i for i, _ in rc.history],
            "solve_stencil: same V-cycles on GPU and CPU")
    require(du <= bnd, "solve_stencil GPU and CPU within the bound")

    side = FREE_IR_SIDE
    b_cpu = poisson.rhs(side, device="cpu").reshape(side, side)
    rg = solve_ir(side, b_cpu.to(dev), tolerance=1e-9, device=dev)
    rc = solve_ir(side, b_cpu, tolerance=1e-9, device="cpu")
    print(f"gpu vs cpu free solve_ir {side}^2 tol 1e-9: V-cycles "
          f"{rg.iterations} / {rc.iterations}, rss {rg.error:.6e} / "
          f"{rc.error:.6e}")
    require(rg.converged and rc.converged, "free solve_ir converged")
    require(rg.iterations == rc.iterations
            and len(rg.history) == len(rc.history),
            "free solve_ir: same counts on GPU and CPU")



# The loop graphs (JAX's one-program solve loops): (label, side,
# StructuredSolver options (None: solve_pcg_device, f32, fused, on the
# packed hierarchy), jump operator, tolerance, refines or iterations)
GRAPH_ROWS = (
    ("const", 1023, {}, False, TOL, 2),
    ("const", 4095, {}, False, TOL, 3),
    ("const", 8191, {}, False, TOL, 3),
    ("const fused", 4095, {"smoother": "fused"}, False, TOL, 3),
    ("var fused df32", 4095, {"smoother": "fused"}, True, 1e-5, 7),
    ("var f64", 4095, {"precision": "f64"}, True, 1e-7, 16),
    ("pcg", 2047, None, False, PCG_TOL, 4),
    ("pcg", 4095, None, False, PCG_TOL, 5),
)
PCG_GRAPH_ITERS = 50
# the condition kernel's bytes per evaluation: err, tol (f64), it, n
# (int32) read, it written, two u64 counts read and written
LOOP_COND_BYTES = 8 + 8 + 4 + 4 + 4 + 2 * 2 * 8
LOOP_TIMED_PASSES = 1000
# (refine piece, final piece, x0, tol, n): err = x0 / 2^pass, the edge
# cases of the condition (a NaN err, an empty budget, a converged entry)
LOOP_CASES = ((False, False, 1.0, 0.1, 40), (True, True, 1.0, 0.1, 40),
              (True, True, 1.0, 0.1, 2), (True, True, 1.0, 0.1, 0),
              (False, False, 1.0, 0.1, 2), (False, False, 0.05, 0.1, 40),
              (True, True, 0.05, 0.1, 40), (True, True, float("nan"), 0.1,
                                            40),
              (False, False, float("nan"), 0.1, 40),
              (True, True, 1.0, float("inf"), 40))


def toy_loop(dev, refine: bool, final: bool):
    """A loop of graph_loop.DeviceLoop with one-kernel pieces: the body
    writes err = x and halves x; refine and final count their runs.
    Returns (loop, pre(x0, tol, n), counts)."""
    t = {"err": torch.zeros((), dtype=torch.float64, device=dev),
         "tol": torch.zeros((), dtype=torch.float64, device=dev),
         "it": torch.zeros((), dtype=torch.int32, device=dev),
         "n": torch.zeros((), dtype=torch.int32, device=dev)}
    x = torch.zeros((), dtype=torch.float64, device=dev)
    cnt = torch.zeros(3, dtype=torch.float64, device=dev)
    inp = torch.zeros(3, dtype=torch.float64, device=dev)

    def body():
        t["err"].copy_(x)
        x.mul_(0.5)
        cnt[0].add_(1.0)

    def ref():
        cnt[1].add_(1.0)

    def fin():
        cnt[2].add_(1.0)

    def pre():
        x.copy_(inp[0])
        t["tol"].copy_(inp[1])
        t["n"].copy_(inp[2])
        t["err"].fill_(float("inf"))
        t["it"].zero_()
        cnt.zero_()

    loop = graph_loop.DeviceLoop(body, ref if refine else None,
                                 fin if final else None, **t)
    return loop, pre, inp, cnt, t["it"]


def loop_condition_parity_and_timing(dev):
    """The condition kernel (csrc/graph_loop.cu) in a loop graph against
    the host driver of the same loop (its plain version, graph_loop.
    loop_condition) over LOOP_CASES: the body, refine and final runs and
    the final it equal. Its time: a WHILE node of LOOP_TIMED_PASSES passes
    whose body is one one-thread kernel, per pass (CUDA events), against
    the host driver's pass (the plain condition and its one read);
    bound: LOOP_COND_BYTES over the memory rate."""
    worst = 0.0
    for refine, final, x0, tol, n in LOOP_CASES:
        loop, pre, inp, cnt, it = toy_loop(dev, refine, final)
        inp.copy_(torch.tensor([x0, tol, float(n)], dtype=torch.float64))
        loop.run_host(pre, lambda: None)
        want = cnt.tolist() + [int(it)]
        g = loop.graph(pre, lambda: None)
        g.launch()
        torch.cuda.synchronize()
        got = cnt.tolist() + [int(it)]
        diff = max(abs(a - b) for a, b in zip(got, want))
        worst = max(worst, diff)
        print(f"parity loop_condition refine={refine} final={final} x0 "
              f"{x0} tol {tol} n {n}: graph (body, refine, final, it) "
              f"{got}, host driver {want}, equal {diff == 0}")
        require(diff == 0, "the loop graph runs the host driver's loop")
    loop, pre, inp, cnt, it = toy_loop(dev, False, False)
    inp.copy_(torch.tensor([1.0, -1.0, float(LOOP_TIMED_PASSES)],
                           dtype=torch.float64))
    g = loop.graph(pre, lambda: None)

    def graph_run():
        g.launch()

    def host_run():
        loop.run_host(pre, lambda: None)
    host_run()
    graph_ms = time_ms(graph_run, 5) / LOOP_TIMED_PASSES
    require(int(it) == LOOP_TIMED_PASSES, "the timed loop's passes")
    host_ms = time_ms(host_run, 1) / LOOP_TIMED_PASSES
    b_ms, by = bound(LOOP_COND_BYTES, 3)
    print(f"time loop_condition: {graph_ms:.6f} ms a pass in the graph "
          f"(body one one-thread kernel), host driver {host_ms:.6f} ms a "
          f"pass (x{host_ms / graph_ms:.1f}), bound {b_ms:.2e} ms "
          f"({by}); {card()}")
    del g, loop
    return worst, (graph_ms, host_ms), (b_ms, by)


def masked_cycle_ops(w33s, side: int, down: bool) -> int:
    """f32 operations of K10 (down) or K11 over the levels of ``w33s`` from
    ``side``: a sweep a level, and the residual and the two transfer
    products (3 products and adds an entry of P1^T r, then of its product
    with P1) or the prolongation (2 for an even row or column) and the
    correction's add."""
    ops = 0
    for w33 in w33s:
        nc = (side - 1) // 2
        ops += sweep_ops(w33, side * side)
        ops += (residual_ops(w33, side * side) + 6 * (nc * side + nc * nc)
                if down else 2 * (side * nc + side * side) + side * side)
        side = nc
    return ops


def as_graph(fn, reps: int, dev):
    """The launch of a CUDA graph of ``reps`` calls of ``fn``: timed as
    the solves run them, so that a plain version's many launches do not
    time the host."""
    return graph_loop.StraightGraph(
        lambda: [fn() for _ in range(reps)], dev).launch


def masked_cycle_parity_and_timing(dev):
    """K10 -> the coarsest LU -> K11 against the plain twins' cycle (the
    existing ops) on the card, entered at each masked level of the Poisson
    hierarchy from MASKED_TIMED^2 down, u = 0 and the FMG's nonzero u,
    symmetric and forward: the coarsest b, the workspace and u bitwise.
    At MASKED_TIMED^2: K10 and K11 alone and their plain twins, each as a
    CUDA graph of MASKED_GRAPH_LAUNCHES calls (a graph, as in the solves:
    the twins' thousands of launches would time the host), per call, the
    better of two interleaved runs; then one whole masked V-cycle as a
    graph, the kernels' against the plain ops', with each graph's nodes.
    Bound: each input read once, each output written once, or the
    operations. Returns ({name: max_abs_err}, {name: (kernel ms, plain
    ms)}, {name: bound})."""
    hier = structured.build_stencil_hierarchy_device(
        MASKED_TIMED, smoother="packed", device=dev)
    rng = np.random.default_rng(MASKED_TIMED)
    worst = 0.0
    for l, side in enumerate(hier.sides[:-1]):
        w33s = hier.w33s[l:-1]
        b = torch.as_tensor(rng.standard_normal((side, side)),
                            dtype=torch.float32, device=dev)
        for zero_u in (True, False):
            u = (torch.zeros_like(b) if zero_u else torch.as_tensor(
                rng.standard_normal((side, side)), dtype=torch.float32,
                device=dev))
            for sym in (True, False):
                bc, ws = masked_down_leg(u, b, w33s, 1, 1.0, sym)
                pbc, pws = masked_down_leg_plain(u, b, w33s, 1, 1.0, sym)
                got = masked_up_leg(hier.coarse_solve(bc).contiguous(), b,
                                    ws, w33s, 1, 1.0, sym)
                want = masked_up_leg_plain(
                    hier.coarse_solve(pbc).contiguous(), b, pws, w33s, 1,
                    1.0, sym)
                same = (torch.equal(bc, pbc) and torch.equal(ws, pws)
                        and torch.equal(got, want))
                d, _ = rel_err(got, want)
                worst = max(worst, d)
                print(f"parity K10/K11 masked V-cycle entered at {side}^2 "
                      f"u={'0' if zero_u else 'fmg'} symmetric={sym}: "
                      f"coarsest b, workspace and u bitwise equal {same} "
                      f"(max_abs {d:.3e})")
                require(same, f"K10/K11 bitwise their plain twins at "
                        f"{side}^2")
    side = MASKED_TIMED
    w33s = hier.w33s[:-1]
    b = torch.as_tensor(rng.standard_normal((side, side)),
                        dtype=torch.float32, device=dev)
    u = torch.zeros_like(b)
    bc, ws = masked_down_leg(u, b, w33s)
    uc = hier.coarse_solve(bc).contiguous()
    n = MASKED_GRAPH_LAUNCHES
    runs = {"masked_down_leg": (
                lambda: masked_down_leg(u, b, w33s),
                lambda: masked_down_leg_plain(u, b, w33s)),
            "masked_up_leg": (
                lambda: masked_up_leg(uc, b, ws, w33s),
                lambda: masked_up_leg_plain(uc, b, ws, w33s))}
    times, bounds = {}, {}
    nws = workspace_floats(side, len(w33s)) * 4
    field = side * side * 4
    nbytes = {"masked_down_leg": 2 * field + nws + bc.nbytes,
              "masked_up_leg": uc.nbytes + nws + 2 * field}
    for name, (kern, plain) in runs.items():
        p_ms, k_ms = alternating(as_graph(plain, 1, dev),
                                 as_graph(kern, n, dev), 5, 20)
        k_ms /= n
        bnd = bound(nbytes[name], masked_cycle_ops(
            w33s, side, name == "masked_down_leg"))
        print(f"time {name} entry {side}^2: kernel {k_ms:.4f} ms a call, "
              f"plain twin {p_ms:.4f} ms (graphs; x{p_ms / k_ms:.1f}); "
              f"bound {bnd[0]:.2e} ms ({bnd[1]}); {card()}")
        times[name] = (k_ms, p_ms)
        bounds[name] = bnd

    def kernel_cycle():
        bc2, ws2 = masked_down_leg(u, b, w33s)
        return masked_up_leg(hier.coarse_solve(bc2).contiguous(), b, ws2,
                             w33s)

    def plain_cycle():
        pbc2, pws2 = masked_down_leg_plain(u, b, w33s)
        return masked_up_leg_plain(hier.coarse_solve(pbc2).contiguous(), b,
                                   pws2, w33s)
    out = {}
    nodes = {}
    for name, fn in (("kernels", kernel_cycle), ("plain", plain_cycle)):
        dst = out[name] = torch.empty_like(b)
        g = graph_loop.StraightGraph(lambda fn=fn, dst=dst: dst.copy_(fn()),
                                     dev)
        nodes[name] = (len(graph_loop.node_types(g._graph.raw_cuda_graph()))
                       - 1, g)
    p_ms, k_ms = alternating(nodes["plain"][1].launch,
                             nodes["kernels"][1].launch, 5, 50)
    require(torch.equal(out["kernels"], out["plain"]),
            "the masked V-cycle graphs agree bitwise")
    print(f"time masked V-cycle entry {side}^2 (a graph each, the copy out "
          f"not counted in the nodes): K10 + LU + K11 {k_ms * 1e3:.2f} us, "
          f"{nodes['kernels'][0]} nodes; plain ops {p_ms * 1e3:.2f} us, "
          f"{nodes['plain'][0]} nodes (x{p_ms / k_ms:.1f}); {card()}")
    del nodes, out
    return ({k: worst for k in MASKED_LEGS}, times, bounds)


def k12_planes(side: int, kind: str, dev) -> torch.Tensor:
    """Kellogg's f32 planes at ``side`` ("kellogg"), or a Galerkin level of
    them ("galerkin": the planes of side 2 side + 1 coarsened once, in f32
    as the solver's hierarchy coarsens them)."""
    if kind == "kellogg":
        return varcoef.kellogg_planes(side, torch.float32, device=dev)
    return rap_stencil_planes(varcoef.kellogg_planes(
        2 * side + 1, torch.float32, device=dev))


def masked_var_sweep_parity_and_timing(dev):
    """K12 bitwise against the plain masked sweep (gs4_sweep_masked with
    color_masks_iota) at K12_SIDES, on Kellogg's planes and on a Galerkin
    level of them, symmetric and forward, omega 1 and 0.8, u and b from a
    seed. At K12_TIMED, on the Galerkin level (2047^2: the jump cell's
    level below the fine one): K12 and the plain sweep, each as a CUDA
    graph (K12_GRAPH_LAUNCHES calls of K12, one of the plain sweep), per
    call, the better of two interleaved runs, against the bound: u, b and
    the nine planes read once and u written once, 48 B a cell. Returns
    ({name: max_abs_err}, {name: (kernel ms, plain ms)}, {name: bound},
    {n: (ms, bound ms)})."""
    worst = 0.0
    for side in K12_SIDES:
        g = torch.Generator(device=dev).manual_seed(side)
        u, b = (torch.randn((side, side), generator=g, device=dev)
                for _ in range(2))
        masks = color_masks_iota(side, torch.float32, dev)
        for kind in ("kellogg", "galerkin"):
            S = Stencil2D(side=side, c=k12_planes(side, kind, dev))
            for symmetric in (True, False):
                for omega in (1.0, 0.8):
                    got = masked_gs4_sweep_var(S, u, b, omega, symmetric)
                    ref = gs4_sweep_masked(S, u, b, masks, omega, symmetric)
                    d, r = rel_err(got, ref)
                    worst = max(worst, d)
                    same = torch.equal(got, ref)
                    print(f"parity K12 {kind} n={side} symmetric="
                          f"{symmetric} omega={omega}: max_abs {d:.3e} rel "
                          f"{r:.3e}, bitwise equal {same}")
                    require(same, f"K12 bitwise the plain masked sweep "
                            f"({kind}, n={side}, symmetric={symmetric}, "
                            f"omega={omega})")
            del S
    times, bounds, by_n = {}, {}, {}
    n = K12_GRAPH_LAUNCHES
    for side in K12_TIMED:
        g = torch.Generator(device=dev).manual_seed(side + 1)
        u, b = (torch.randn((side, side), generator=g, device=dev)
                for _ in range(2))
        masks = color_masks_iota(side, torch.float32, dev)
        S = Stencil2D(side=side, c=k12_planes(side, "galerkin", dev))
        p_ms, k_ms = alternating(
            as_graph(lambda: gs4_sweep_masked(S, u, b, masks), 1, dev),
            as_graph(lambda: masked_gs4_sweep_var(S, u, b), n, dev), 5, 20)
        k_ms /= n
        cells = side * side
        # nine products and adds, b - acc, the reciprocal, two products
        # and the add an update, each cell twice
        bnd = bound(3 * u.nbytes + S.c.nbytes, cells * 2 * (2 * 9 + 5))
        print(f"time {MASKED_SWEEP} n={side}: kernel {k_ms:.4f} ms a "
              f"symmetric sweep, plain {p_ms:.4f} ms (graphs; "
              f"x{p_ms / k_ms:.1f}); bound {bnd[0]:.4f} ms ({bnd[1]}, "
              f"{100 * bnd[0] / k_ms:.1f} % of it); {card()}")
        by_n[side] = (k_ms, bnd[0])
        if side == K12_TIMED[0]:
            times[MASKED_SWEEP] = (k_ms, p_ms)
            bounds[MASKED_SWEEP] = bnd
        del S
    return {MASKED_SWEEP: worst}, times, bounds, by_n


def dispatch(run):
    """``run()`` under torch.cuda.set_sync_debug_mode("error"): returns
    (its result, the dispatch seconds, the wall to the end of the work,
    whether the work was still running when the call returned)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = run()
        t1 = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pending = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    return out, t1 - t0, time.perf_counter() - t0, pending


def graph_row(dev, label, side, kw, jump, tol):
    """One GRAPH_ROWS row's solver: (the public entry point's run, the
    host-loop oracle's run, the graphs' capture, the expected launch
    counts for ``it``, the loop's pieces by name). Each run returns (the
    outputs to hold bitwise, stats)."""
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    if kw is None:
        hier = build_stencil_hierarchy_device(side, smoother="packed",
                                              device=dev)
        b = b2.to(torch.float32)
        L = krylov._pcg_state(hier, b, True, None, PCG_GRAPH_ITERS)
        legs = level_plan(hier, 1, 1, PACKED_MIN_SIDE, True).count(
            "legs")

        def run():
            return solve_pcg_device(hier, b, tolerance=tol,
                                    n_iters=PCG_GRAPH_ITERS, fused=True)

        def oracle():
            return krylov._solve_pcg_device(hier, b, tol, PCG_GRAPH_ITERS,
                                            True, None, host=True)

        def capture():
            krylov._pcg_graph(L)
            return [L.graph]

        def want(it):
            return Counter({"fused_down_leg_packed": legs * (it + 1),
                            "fused_up_leg_packed": legs * (it + 1),
                            "masked_down_leg": it + 1,
                            "masked_up_leg": it + 1,
                            LOOP: loop_conditions(it)})
        return run, oracle, capture, want, pieces(L.loop, *L.program)
    opts = dict(kw)
    if jump:
        opts["A_planes"] = varcoef.jump_planes(side, a_in=100.0, device=dev)
    s = StructuredSolver(side, device=dev, **opts)
    if s.packed_loop:
        b4 = s.prepare_b(b2)

        def run():
            u4, stats = s.solve_ir_device_prepared(b4, tolerance=tol)
            return (u4.hi, u4.lo), stats

        def oracle():
            u4, stats = s._solve_prepared(b4, tol, 40, 0.0, host=True)
            return (u4.hi, u4.lo), stats[:2]
    else:
        def run():
            u, stats = s.solve_ir_device(b2, tolerance=tol)
            return (u,), stats

        def oracle():
            u, stats = s._solve_device(b2, tol, 40, 0.0, host=True)
            return (u,), stats[:2]

    def capture():
        return [s._graph(name) for name in s._loop_state().programs]

    def want(it):
        if s.packed_loop:
            return solve_launches(s.plan, s.hier.sides, it)
        c = Counter({LOOP: loop_conditions(it)})
        if kw.get("smoother") == "fused":
            c["fused_gs4_sweep_var" if jump else "fused_gs4_sweep_const"] \
                = 2 * (1 + 3 * it)
        if not jump:
            # the constant masked levels' K10/K11: the FMG's cycle at
            # each level and every V-cycle of the refines
            for k in MASKED_LEGS:
                c[k] = s.hier.n_levels - 1 + s.cycles_per_refine * it
        else:
            c[MASKED_SWEEP] = k12_launches(s, it)
        return c
    L = s._loop_state()
    program = L.programs["prepared" if s.packed_loop else "device"]
    return run, oracle, capture, want, pieces(L.loop, *program)


def pieces(loop, pre, post) -> dict:
    """A loop's pieces by name (the names of LoopGraph.execs' counts)."""
    return {"pre": pre, "body": loop.body, "refine": loop.refine,
            "final": loop.final, "post": post}


def pieces_busy(parts: dict, runs: dict) -> float:
    """Device busy seconds of a solve from its pieces: each piece run
    eagerly once under torch.profiler (the card's activity only), its
    kernels' and copies' time, times its runs in the solve. Under a
    process group the pieces' collectives are the host ones: NCCL's
    kernels wait for their peers and are not busy time (``traced``'s
    rule). Collective there: every process calls it alike."""
    busy = 0.0
    for name, fn in parts.items():
        if fn is None or not runs.get(name):
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy += runs[name] * 1e-6 * sum(
            _device_us(e) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("nccl"))
    return busy


def graph_span(run) -> float:
    """Seconds on the card from one run's first launch to its last work
    (CUDA events on the stream)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e-3


def graph_solves(dev, launches: dict):
    """JAX's one-dispatch device loops on the card (GRAPH_ROWS): for each
    row the loop graphs' capture and instantiation (seconds, the memory
    they take), the host-loop oracle (the same pieces, host-driven; its
    wall, then a traced run for the device busy time and its launches),
    then one solve through the public entry point under drive and
    set_sync_debug_mode("error"): one graph launch that returns before
    the work ends, u and stats bitwise the oracle's, the refines or
    iterations of the row, the kernels' launch counts; then the graph's
    wall (median of 3) and its span on the card (CUDA events). The graph
    is not traced: CUPTI's records of a WHILE body that runs many passes
    faulted the card (an illegal address at 16 passes), and a trace of a
    whole solve takes minutes to process. The device busy time of both
    loops is their pieces' (pieces_busy: each traced once, times its runs
    in the solve, read off the graph's device counts); the idle share is
    1 - busy / wall."""
    cardline = card()
    for label, side, kw, jump, tol, want_it in GRAPH_ROWS:
        t_row = time.perf_counter()
        run, oracle, capture, want, parts = graph_row(dev, label, side, kw,
                                                      jump, tol)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t_row
        gc.collect()
        graph_loop.settle()             # frees the last row's graphs
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        graphs = capture()
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - m0) / 2 ** 30
        held = (torch.cuda.memory_allocated() - m0) / 2 ** 30
        t0 = time.perf_counter()
        ref, ref_stats = oracle()
        torch.cuda.synchronize()
        h_wall = time.perf_counter() - t0
        run()                           # the graph's first launch
        torch.cuda.synchronize()
        n0 = sum(g.launches for g in graphs)
        e0 = sum(g.execs for g in graphs)
        ((out, stats), disp, wall1, pending), c = drive(
            lambda: dispatch(run), launches)
        n_graph = sum(g.launches for g in graphs) - n0
        execs = (sum(g.execs for g in graphs) - e0).tolist()
        err, it = stats.tolist()
        it = int(it)
        same = (all(torch.equal(a, b) for a, b in zip(out, ref))
                and torch.equal(stats, ref_stats))
        w = want(it)
        counts_ok = all(c[k] == w[k] for k in set(c) | set(w))
        g_med, g_walls = wall_median(run, 3)
        span = graph_span(run)
        h_busy = pieces_busy(parts, {"pre": execs[0], "post": execs[0],
                                     "body": execs[1], "refine": execs[2],
                                     "final": execs[3]})
        RECORD[f"graph {label} {side}"] = {
            "it": it, "wall": g_med, "span": span, "busy": h_busy,
            "host_wall": h_wall, "capture_s": cap_s, "peak_gib": peak,
            "dispatch_s": disp}
        print(f"graph {label} {side}^2 tol {tol:g}: setup {setup:.2f} s, "
              f"capture + instantiate {cap_s:.3f} s ({len(graphs)} "
              f"graph(s)), memory peak +{peak:.3f} GiB, held after "
              f"+{held:.3f} GiB; refines {it} (row {want_it}), rss "
              f"{err:.6e}, u and stats bitwise the host loop's {same}, "
              f"graph launches {n_graph}, dispatch {disp * 1e3:.3f} ms of "
              f"{wall1:.6f} s, returned before the work ended {pending}, "
              f"launches {dict(c)} (expected {dict(w)}); {cardline}")
        print(f"graph wall {label} {side}^2: graph median of 3 {g_med:.6f} "
              f"s (all {g_walls}), span on the card {span:.6f} s, device "
              f"busy {h_busy:.6f} s (the pieces' runs {execs}), idle share "
              f"{1 - h_busy / g_med:.4f}; host loop "
              f"{h_wall:.6f} s, idle share {1 - h_busy / h_wall:.4f}; row "
              f"{time.perf_counter() - t_row:.1f} s; {cardline}")
        require(same, f"graph {label} {side}^2: u and stats bitwise the "
                "host loop's")
        require(it == want_it, f"graph {label} {side}^2: {want_it} refines")
        require(err <= tol or (jump and kw.get("precision") == "f64"
                               and err <= 1e-5),
                f"graph {label} {side}^2 converged")
        require(n_graph == 1, f"graph {label} {side}^2: one graph launch")
        require(pending, f"graph {label} {side}^2: the call returns before "
                "the solve ends")
        require(counts_ok, f"graph {label} {side}^2: launch counts")
        del run, oracle, capture, graphs, out, ref
    stepped_rows(dev, launches)


def stepped_graph_row(label: str, graph_run, host_run, n_graph, want,
                      one_launch, launches: dict, parts=None,
                      blocks: int = 1, reps: int = 3):
    """One host-stepped solve whose programs are straight CUDA graphs (a
    chunk loop's, StructuredSolver.solve_ir's refine, EllDistSolver's
    vcycle / rss / refine), the host reading the rss between them as
    JAX's host loops do. ``graph_run()`` and ``host_run()``: the same
    solve under the graph and the host driver (SolveResults);
    ``n_graph()`` the graph launches so far; ``want(result)`` a call's;
    ``one_launch()`` one launch's (dispatch seconds, returned before its
    work ended). The first graph run (its graphs captured and
    instantiated at first use inside), the host driver's run and the
    graph's under drive: u, the count, the rss and the history bitwise,
    the kernels' launch counts equal (the peer collective in the graphs
    over several blocks in all: ``blocks`` a process, or processes), the
    graph launches; then both walls (median of ``reps``) and, with
    ``parts`` (``parts(result)``: the solve's
    pieces by name and each one's runs), the device busy time
    (pieces_busy: each piece traced once, eagerly, times its runs; a graph
    is not traced) and each driver's idle share. Returns (graph result,
    RECORD entry, its launch counts)."""
    cardline = card()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph_run()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    ref, hc = drive(host_run, launches)
    n0 = n_graph()
    res, c = drive(graph_run, launches)
    n_g = n_graph() - n0
    same = (torch.equal(res.u, ref.u)
            and (res.iterations, res.error, res.history)
            == (ref.iterations, ref.error, ref.history))
    spread = blocks * launch.world_size() > 1
    counts_ok = (all(c[k] == hc[k] for k in set(c) | set(hc) if k != PEER)
                 and (c[PEER] > 0) == spread and hc[PEER] == 0)
    g_med, g_walls = wall_median(graph_run, reps)
    h_med, h_walls = wall_median(host_run, reps)
    disp, pending = one_launch()
    rec = {"it": res.iterations, "wall": g_med, "host_wall": h_med,
           "first_s": first, "capture_s": max(first - g_med, 0.0),
           "dispatch_s": disp, "graph_launches": n_g, "busy": None}
    busy_txt = ("device busy not measured (a card group, or processes "
                "sharing a card)")
    if parts is not None:
        pieces, runs = parts(res)
        busy = rec["busy"] = pieces_busy(pieces, runs)
        busy_txt = (f"device busy {busy:.6f} s (the pieces' runs {runs}), "
                    f"idle share graph {1 - busy / g_med:.4f}, host driver "
                    f"{1 - busy / h_med:.4f}")
    print(f"stepped graph {label}: V-cycles {res.iterations} (host driver "
          f"{ref.iterations}), rss {res.error:.6e}, checks "
          f"{len(res.history)}; u, count, rss and history bitwise the host "
          f"driver's {same}; graph launches {n_g} (expected "
          f"{want(res)}), one launch's dispatch {disp * 1e3:.3f} ms "
          f"(returned before its work ended {pending}); first call "
          f"{first:.3f} s (capture + instantiate {rec['capture_s']:.3f} s "
          f"by the median), launches {dict(c)} (host driver {dict(hc)}); "
          f"graph wall median of {reps} {g_med:.6f} s (all {g_walls}), host "
          f"driver {h_med:.6f} s (all {h_walls}; x{h_med / g_med:.2f}); "
          f"{busy_txt}; {cardline}")
    require(same, f"{label}: bitwise the host driver's")
    require(n_g == want(res), f"{label}: one graph launch a program run")
    require(counts_ok, f"{label}: launch counts {dict(c)} against the host "
            f"driver's {dict(hc)}")
    require(pending, f"{label}: a launch returns before its work ends")
    RECORD[f"stepped graph {label}"] = rec
    return res, rec, c


def chunk_launches(loops) -> int:
    """The graph launches of a hierarchy's chunk loops so far."""
    return sum(g.launches for loop in list(loops.values())
               for g in loop.graphs.values())


def chunk_parts(loops, every: int):
    """stepped_graph_row's ``parts`` of a chunk loop solve: the chunk of
    ``every`` V-cycles, the remainder's, the rss."""
    def parts(res):
        loop = next(lp for lp in loops.values() if every in lp.graphs)
        full, rest = divmod(res.iterations, every)
        return ({"chunk": loop._chunk(every),
                 "rest": loop._chunk(rest) if rest else None,
                 "rss": loop._rss},
                {"chunk": full, "rest": int(rest > 0),
                 "rss": len(res.history)})
    return parts


def chunk_want(every: int):
    """A chunk loop's graph launches a solve: one a chunk (the checks
    every ``every`` V-cycles, the last chunk the remainder) and one a
    check."""
    def want(res):
        chunks = -(-res.iterations // every) if every else 1
        return chunks + len(res.history)
    return want


def one_chunk_launch(loops, key):
    """One launch of a chunk loop's graph ``key`` under dispatch."""
    def run():
        g = next(loop.graphs[key] for loop in loops.values()
                 if key in loop.graphs)
        _, disp, _, pending = dispatch(g.launch)
        return disp, pending
    return run


def stepped_rows(dev, launches: dict):
    """graph_solves' host-stepped rows: StructuredSolver.solve_ir at
    REFINE_SIDE^2 (refine_solves' solver: K2/K3 in each refine graph,
    one launch a step) and solve_stencil for STENCIL_GRAPH_CYCLES
    V-cycles on the constant smoother="fused" REFINE_SIDE^2 hierarchy
    (var_solves' solver: K5 in each chunk graph)."""
    side = REFINE_SIDE
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    s = RECORD.pop("refine solver")
    s._graphs.pop("refine")             # captured again, inside the row

    def one_refine():
        _, disp, _, pending = dispatch(s._graphs["refine"].launch)
        return disp, pending
    res, _, _ = stepped_graph_row(
        f"solve_ir {side}^2", lambda: s.solve_ir(b2, TOL),
        lambda: s._solve_ir(b2, TOL, 40, host=True),
        lambda: s._graphs["refine"].launches, lambda r: len(r.history),
        one_refine, launches, lambda r: ({"refine": s._refine_state().step},
                                         {"refine": len(r.history)}))
    require(res.converged and len(res.history) == REFINE_STEPS,
            f"solve_ir {side}^2: {REFINE_STEPS} steps")
    del s

    s = RECORD.pop("fused solver")
    h = s.hier
    b32 = b2.to(torch.float32)
    every, n = STENCIL_GRAPH_EVERY, STENCIL_GRAPH_CYCLES
    kw = dict(tolerance=0.0, compute_error_every_n_iters=every, n_iters=n)
    res, _, c = stepped_graph_row(
        f"solve_stencil fused {side}^2", lambda: solve_stencil(
            h, b32, device=dev, **kw),
        lambda: structured._solve_stencil(h, b32, None, 0.0, every, n, 1,
                                          1, 1.0, True, dev, host=True),
        lambda: chunk_launches(h.chunk_loops), chunk_want(every),
        one_chunk_launch(h.chunk_loops, every), launches,
        chunk_parts(h.chunk_loops, every))
    k5 = c["fused_gs4_sweep_const"]
    print(f"solve_stencil fused {side}^2: {n} V-cycles, K5 launches {k5} "
          f"(2 a V-cycle on the fine level), rss history {res.history}")
    require(res.iterations == n and k5 == 2 * n
            and sum(tpu_counts(c).values()) == k5,
            "solve_stencil fused: K5 = 2 a V-cycle, no other kernel")
    del s, h


def ell_pcg_device(blk, tol: float, n_iters: int):
    """EllDistSolver's PCG program on a block: (u slabs, [rss, passes])
    of one run, with no read."""
    L = blk._state()
    bp = blk.pad_vec(blk.b)

    def inputs():
        L.b.copy_(bp)
        L.p_tol.fill_(tol)
        L.p_n.fill_(n_iters)
    blk._run("pcg", inputs)
    return L.u.clone(), L.p_stats.clone()


def ell_graph_launches(s, names) -> int:
    """The graph launches of ``names`` on every block so far."""
    return sum(per_block(s, lambda blk: sum(
        blk._graphs[n].launches for n in names if n in blk._graphs)))


def ell_solve_counts(res) -> dict:
    """The program runs of an EllDistSolver ``solve``."""
    return {"vcycle": res.iterations, "rss": len(res.history)}


def ell_graph_row(label: str, s, run, counts, launches,
                  timed: bool = True, reps: int = 3):
    """An EllDistSolver solve (``run(s)``) under the graph driver against
    the host driver (stepped_graph_row), the programs captured first
    (``warmup``, timed), one vcycle launch's dispatch on every block;
    ``counts(result)``: its program runs a block, which are its graph
    launches and, ``timed``, the pieces' runs of its busy time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.set_driver("graph")
    s.warmup()
    torch.cuda.synchronize()
    cap = time.perf_counter() - t0

    def host():
        s.set_driver("host")
        try:
            return run(s)
        finally:
            s.set_driver("graph")

    def one_launch():
        outs = group_dispatch(s, lambda blk: blk._go("vcycle"))
        return max(o[1] for o in outs), all(o[2] for o in outs)
    print(f"stepped graph {label}: capture + instantiate of the programs "
          f"{cap:.3f} s ({len(s.devices)} block(s))")
    blocks = len(s.devices)
    res, rec, _ = stepped_graph_row(
        label, lambda: run(s), host,
        lambda: ell_graph_launches(s, ("vcycle", "rss", "refine")),
        lambda r: blocks * sum(counts(r).values()), one_launch, launches,
        (lambda r: (s._state().straight, counts(r))) if timed else None,
        blocks, reps)
    rec["capture_s"] = cap
    return res


def ell_graph_solves(dev, launches: dict):
    """The last single-process host-stepped loops of the ELL path as CUDA
    graphs, each against the host driver of the same pieces (bitwise, a
    graph launch a program run, dispatch, walls, idle): the single-device
    Multigrid (a) at ELL_SIDE^2 (ell_solves' hierarchy: a chunk graph a
    V-cycle and an rss graph a check), then EllDistSolver's four programs
    on ell_dist_solves' solvers (ELL_SIDE^2 on ELL_DIST_SLABS slabs: the
    bilinear solve under "step" and "strips", the f64 PCG, one WHILE
    launch, the f32 solve_ir, a refine graph a step, and the flat
    12-level solve) and on card_solves' card group of CARD_BLOCKS blocks
    on the one card ("strips": each block's graphs, the peer collective
    kernel inside, bitwise one block's)."""
    h, sm, b = RECORD.pop("ell (a) solver")
    h.chunk_loops.clear()               # captured again, inside the row
    res, _, _ = stepped_graph_row(
        f"ell (a) multigrid.solve {ELL_SIDE}^2", lambda: solve(
            h, sm, b, tolerance=ELL_TOL, compute_error_every_n_iters=1),
        lambda: multigrid._solve(h, sm, b, None, ELL_TOL, 1, 100,
                                 host=True),
        lambda: chunk_launches(h.chunk_loops), chunk_want(1),
        one_chunk_launch(h.chunk_loops, 1), launches,
        chunk_parts(h.chunk_loops, 1))
    require(res.iterations == ELL_A_CYCLES, f"ell (a): {ELL_A_CYCLES} "
            "V-cycles")
    del h, sm, b
    side, D = ELL_SIDE, ELL_DIST_SLABS
    solvers = RECORD.pop("ell dist solvers")
    one = {}
    for halo in ("step", "strips"):
        s = solvers[halo]
        one[halo] = ell_graph_row(
            f"ell dist {side}^2 D={D} {halo} solve", s,
            lambda s: s.solve(tolerance=ELL_TOL,
                              compute_error_every_n_iters=1),
            ell_solve_counts, launches)
    # the one-block PCG the process workers hold theirs to (mp_solves)
    save_reference(RECORD["mp_dir"], "ell_pcg",
                   drive(lambda: solvers["strips"].solve_pcg(
                       tolerance=ELL_TOL), launches)[0])
    s = solvers["step"]
    L = s._state()
    dist_graph_program(
        f"ell dist {side}^2 D={D} f64", s, "pcg",
        lambda blk: ell_pcg_device(blk, ELL_TOL, 100), launches,
        lambda: s.solve_pcg(tolerance=ELL_TOL),
        busy_parts=pieces(*L.loops["pcg"]))
    s = solvers["f32"]
    ell_graph_row(f"ell dist {side}^2 D={D} f32 solve_ir", s,
                  lambda s: s.solve_ir(tolerance=ELL_TOL),
                  lambda r: {"refine": len(r.history)}, launches)
    s = solvers["flat"]
    ell_graph_row(f"ell dist flat {side}^2 D={D} {ELL_FLAT_LEVELS} levels",
                  s, lambda s: s.solve(
                      tolerance=0.0, compute_error_every_n_iters=5,
                      n_iters=ELL_FLAT_CYCLES),
                  ell_solve_counts, launches)
    del s, L, solvers
    s = RECORD.pop("card ell solver")
    try:
        res = ell_graph_row(
            f"card group ell {side}^2 D={D} strips, {CARD_BLOCKS} blocks "
            f"on 1 card", s, lambda s: s.solve(
                tolerance=ELL_TOL, compute_error_every_n_iters=1),
            ell_solve_counts, launches, timed=False)
    finally:
        s.close()
    ref = one["strips"]
    same = (torch.equal(res.u, ref.u.to(res.u.device))
            and (res.iterations, res.history)
            == (ref.iterations, ref.history))
    print(f"card group ell {side}^2 D={D} strips graph: one block's u, "
          f"count and rss history bitwise {same}")
    require(same, "card group ell: one block's graph solve, bitwise")


def halo_parity_and_timing(dev):
    """K7 against its plain version, bitwise (it is a copy): f32 and f64,
    u and b given apart and stacked as one u|b slab, into a new tensor and
    into ``out=``, and as strided views (the slab rows of a framed field),
    at HALO_SHAPES. At the path's shape in f32, in the path's call form
    (u and b apart, ``out=`` the level's buffer): the per-call time (20
    back-to-back calls between CUDA events) against the plain version, and
    in turns against one PyTorch call that computes the same strips:
    index_select of the rows of the stacked u|b field with one zero row
    appended (field, zero row and index made outside the timing); then the
    kernel's own device time, from a CUDA graph of K7_GRAPH_LAUNCHES
    launches replayed, and from torch.profiler's kernel time. Returns
    max_abs_err, the times, the bound, the library call's ms and the
    graph's device ms per launch."""
    err = 0.0
    for D, B, n, G in HALO_SHAPES:
        for dtype in (torch.float32, torch.float64):
            g = torch.Generator(device=dev).manual_seed(D * B + n)
            u, b = (torch.randn((D, B, n), generator=g, device=dev,
                                dtype=dtype) for _ in range(2))
            framed = torch.randn((2, D, B + 2 * G, n + 4), generator=g,
                                 device=dev, dtype=dtype)
            uv, bv = framed[0, :, G:G + B, 4:], framed[1, :, G:G + B, 4:]
            out = torch.full((D, 2 * G, 2 * n), float("nan"), device=dev,
                             dtype=dtype)
            ref = rdma_halo_exchange_plain((u, b), G)
            ref_v = rdma_halo_exchange_plain((uv.contiguous(),
                                              bv.contiguous()), G)
            gots = (K.rdma_halo_exchange((u, b), G),
                    K.rdma_halo_exchange(torch.cat([u, b], dim=2), G),
                    K.rdma_halo_exchange((u, b), G, out=out))
            got_v = K.rdma_halo_exchange((uv, bv), G)
            torch.cuda.synchronize()
            same = (all(torch.equal(x, ref) for x in gots)
                    and torch.equal(got_v, ref_v))
            err = max([err, float((got_v - ref_v).abs().max())]
                      + [float((x - ref).abs().max()) for x in gots])
            print(f"parity K7 D={D} B={B} n={n} G={G} {dtype}: apart, "
                  f"stacked, out=, strided views: bitwise equal {same}")
            require(same, "K7 bitwise equal to its plain version")

    D, B, n, G = HALO_SHAPES[0]
    g = torch.Generator(device=dev).manual_seed(7)
    u, b = (torch.randn((D, B, n), generator=g, device=dev)
            for _ in range(2))
    W = 2 * n
    src = torch.cat([torch.cat([u, b], dim=2).reshape(D * B, W),
                     torch.zeros((1, W), device=dev)])
    zero = D * B
    rows = []
    for d in range(D):
        rows += [(d - 1) * B + B - G + r if d > 0 else zero
                 for r in range(G)]
        rows += [(d + 1) * B + r if d < D - 1 else zero for r in range(G)]
    idx = torch.tensor(rows, device=dev)
    ref = rdma_halo_exchange_plain((u, b), G)
    out = torch.empty_like(ref)

    def gather():
        return torch.index_select(src, 0, idx).reshape(D, 2 * G, W)

    def k7():
        return K.rdma_halo_exchange((u, b), G, out=out)
    require(torch.equal(gather(), ref), "the index_select computes K7's "
            "strips")
    size = f"D={D} B={B} n={n} G={G}"
    times = {}
    interleaved("rdma_halo_exchange", size, k7,
                lambda: rdma_halo_exchange_plain((u, b), G), 20, times)
    lib_ms, k7_ms = alternating(gather, k7, 20)
    new_ms = min(time_ms(lambda: K.rdma_halo_exchange((u, b), G), 20),
                 time_ms(lambda: K.rdma_halo_exchange((u, b), G), 20))
    print(f"time rdma_halo_exchange per call {size} (out=, the path's "
          f"form): {k7_ms:.4f} ms against the library call (index_select "
          f"of the stacked u|b rows + a zero row) {lib_ms:.4f} ms in turns "
          f"(K7 / index_select {k7_ms / lib_ms:.3f}); without out= "
          f"{new_ms:.4f} ms")
    times["rdma_halo_exchange"] = (k7_ms, times["rdma_halo_exchange"][1])

    # the kernel's own device time: a graph of back-to-back launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k7()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(K7_GRAPH_LAUNCHES):
            k7()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(out, ref), "K7's graph replay writes the strips")
    device_ms = min(time_ms(graph.replay, 10),
                    time_ms(graph.replay, 10)) / K7_GRAPH_LAUNCHES
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(K7_GRAPH_LAUNCHES):
            k7()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if "halo_put" in e.key]
    n_k = sum(e.count for e in evts)
    prof_ms = (sum(_device_us(e) for e in evts) / n_k / 1e3 if n_k
               else None)
    # the sent rows read once, the receive strips written once
    es = u.element_size()
    moved = (2 * (D - 1) * G * W + 2 * D * G * W) * es
    bnd = bound(moved, 0)
    prof_txt = f"{prof_ms:.5f} ms" if prof_ms else "not measured"
    print(f"time rdma_halo_exchange device {size}: {device_ms:.5f} ms a "
          f"launch in a CUDA graph of {K7_GRAPH_LAUNCHES} (torch.profiler "
          f"kernel time {prof_txt}) against its bound {bnd[0]:.5f} ms "
          f"({moved / 1e6:.2f} MB); per call through the wrapper "
          f"{k7_ms:.4f} ms")
    return (err, times, {"rdma_halo_exchange": bnd}, lib_ms, device_ms)


def k7_levels(cfg) -> int:
    """Sharded levels whose slabs hold the G strip rows: K7 runs there,
    once per smoothing call; the others take the multi-hop ghost sweep."""
    G = ghost_rows(cfg.pre_sweeps, cfg.symmetric)
    return sum(1 for B in cfg.blocks if B >= G) if cfg.n_devices > 1 else 0


def ell_rss(u: torch.Tensor, b: torch.Tensor, side: int) -> float:
    """Independent f64 rss of a flat ELL solve of the Poisson problem."""
    return f64_rss(u.reshape(side, side).double(),
                   b.reshape(side, side).double(), side)


def traced(fn):
    """(result, device busy s, GPU launches) of one run under
    torch.profiler. NCCL's kernels wait for their peers on a stream of
    their own: they count as launches, not as busy time."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (out, sum(_device_us(e) for e in gpu
                     if not e.key.startswith("nccl")) * 1e-6,
            sum(e.count for e in gpu))


def residual_rounding(A: ELL, u: torch.Tensor, b: torch.Tensor) -> float:
    """gamma_{K+1} || |b| + |A| |u| ||_2: the bound on the 2-norm of the
    rounding error of one evaluation of b - A u (K entries a row)."""
    k1 = A.row_width + 1
    eps = torch.finfo(A.dtype).eps / 2
    absAu = torch.sum(A.data.abs() * u.abs()[A.cols], dim=1)
    return k1 * eps / (1 - k1 * eps) * float(torch.linalg.norm(b.abs()
                                                               + absAu))


def history_close(h1: list, h2: list, g: float) -> tuple[bool, float]:
    """Same check points, and each rss within ELL_CARD_CPU_REL relative or
    within what one rounding of the residual moves it by, 2 sqrt(rss) g:
    near convergence the residual is mostly rounding, and one ulp of
    difference in an iterate (another summation order, another LU) moves
    the rss by more than 1e-10 relative. Returns (ok, the largest
    relative difference)."""
    rel = max((abs(e1 - e2) / e2 for (_, e1), (_, e2) in zip(h1, h2)),
              default=0.0)
    ok = [i for i, _ in h1] == [i for i, _ in h2] and all(
        abs(e1 - e2) <= ELL_CARD_CPU_REL * e2 + 2 * e2 ** 0.5 * g
        for (_, e1), (_, e2) in zip(h1, h2))
    return ok, rel


def ell_testlib(dev):
    """The reference's testlib numbers through Multigrid and the
    standalone symmetric GS, and each other smoother under Multigrid."""
    n = ELL_TESTLIB_SIDE
    A, b = poisson.poisson2d(n, device=dev)
    amg = Multigrid(None, SparseGaussSeidel(), A, b, ELL_TESTLIB_LEVELS,
                    ELL_TOL, 5, 100, device=dev)
    dofs = [amg.get_n_dofs(l) for l in range(ELL_TESTLIB_LEVELS)]
    res = amg.solve(verbose=False)
    ind = ell_rss(res.u, b, n)
    print(f"ell testlib {n}^2 Multigrid(SparseGaussSeidel): dofs {dofs}, "
          f"V-cycles {res.iterations}, rss {res.error:.6e}, independent f64 "
          f"rss {ind:.6e}, history {res.history}")
    require(dofs == ELL_TESTLIB_DOFS, "testlib dof sequence 1225 -> ... -> 8")
    require(res.converged and res.iterations == ELL_TESTLIB_CYCLES,
            f"testlib: {ELL_TESTLIB_CYCLES} V-cycles")
    require(abs(res.error / ELL_TESTLIB_RSS - 1) <= 1e-3
            and abs(ind / res.error - 1) <= 1e-6,
            f"testlib rss {ELL_TESTLIB_RSS} within 1e-3")
    gs = SparseGaussSeidel(ELL_TOL, 100, 1000).smooth(A, torch.zeros_like(b),
                                                      b)
    ind_gs = ell_rss(gs.u, b, n)
    diff = float(torch.linalg.norm(res.u - gs.u))
    scale = min(float(torch.linalg.norm(res.u)),
                float(torch.linalg.norm(gs.u)))
    print(f"ell testlib {n}^2 standalone SparseGaussSeidel: sweeps "
          f"{gs.iterations}, rss {gs.error:.6e}, independent f64 rss "
          f"{ind_gs:.6e}; |u_amg - u_gs| / |u| {diff / scale:.3e}")
    require(gs.converged and gs.iterations == ELL_TESTLIB_SWEEPS
            and gs.error < ELL_TOL and ind_gs < ELL_TOL,
            f"testlib: {ELL_TESTLIB_SWEEPS} GS sweeps to rss < 1e-9")
    require(diff <= 1e-6 * scale, "AMG and GS solutions within 1e-6")
    for sm in (Jacobi(omega=0.9, n_iters=2),
               SuccessiveOverRelaxation(omega=1.5), MulticolorGaussSeidel()):
        r = Multigrid(None, sm, A, b, ELL_TESTLIB_LEVELS, ELL_TOL, 5, 100,
                      device=dev).solve(verbose=False)
        ind = ell_rss(r.u, b, n)
        print(f"ell testlib {n}^2 Multigrid({type(sm).__name__}): V-cycles "
              f"{r.iterations}, rss {r.error:.6e}, independent f64 rss "
              f"{ind:.6e}")
        require(r.converged and ind <= ELL_TOL,
                f"Multigrid({type(sm).__name__}) converged")


def ell_bilinear(dev, A, b, side: int, levels: int, time_it: bool):
    """(a): Multigrid with the bilinear transfer and multicolor GS, the
    Galerkin chain in host scipy. Returns the result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amg = Multigrid(BilinearInterpolator2D(side), MulticolorGaussSeidel(), A,
                    b, levels, ELL_TOL, 1, 100, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    res = amg.solve(verbose=False)
    if not time_it:
        return res
    h = amg.hierarchy
    ind = ell_rss(res.u, b, side)
    split = {k: round(v, 4) for k, v in h.setup_seconds.items()}
    t0 = time.perf_counter()
    rows = 0
    for lev in h.levels:
        greedy_coloring(lev.A.cols.cpu().numpy(), lev.A.data.cpu().numpy(),
                        lev.A.n_rows)
        rows += lev.A.n_rows
    t_color = time.perf_counter() - t0
    RECORD["ell coloring"] = t_color
    print(f"ell (a) bilinear {side}^2 {levels} levels "
          f"{[l.A.n_rows for l in h.levels]}: setup {setup:.3f} s "
          f"(rap {split['rap']}, upload {split['upload']}, smoother "
          f"coloring + panels {split['smoother']}, lu {split['lu']}), "
          f"greedy_coloring alone (native {bindings.available()}) "
          f"{t_color:.3f} s over {rows} rows, a share "
          f"{t_color / setup:.4f} of the setup")
    print(f"ell (a) bilinear {side}^2: V-cycles {res.iterations}, rss "
          f"{res.error:.6e}, independent f64 rss {ind:.6e}")
    require(res.converged and ind <= ELL_TOL,
            f"(a) bilinear {side}^2 converged to {ELL_TOL}")

    def again():   # the host driver (ell_graph_solves: the graph's)
        return multigrid._solve(h, amg.smoother, amg.b, None, ELL_TOL, 1,
                                100, host=True)

    med, walls = wall_median(again, 3)
    r, busy, n_gpu = traced(again)
    RECORD["ell (a) solver"] = (h, amg.smoother, amg.b)
    print(f"ell (a) bilinear {side}^2 solve wall (host driver): median of "
          f"3 {med:.6f} s "
          f"(all {walls}), {med / r.iterations * 1e3:.3f} ms per V-cycle, "
          f"device busy {busy:.6f} s, idle share {1 - busy / med:.4f}, GPU "
          f"launches {n_gpu} ({n_gpu / r.iterations:.1f} per V-cycle)")
    require(r.iterations == res.iterations, "(a) repeat: same V-cycles")
    return res


def ell_device(dev, A, b, levels: int, time_it: bool):
    """(b): the device Galerkin chain over the flattened LinearInterpolator
    structure, multicolor GS for a fixed count of V-cycles. Returns
    (result, hierarchy, plans)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hier, plans = build_hierarchy_device(A, levels, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    sm = MulticolorGaussSeidel()

    def run(host=False):   # tolerance 0: a fixed count of V-cycles
        return multigrid._solve(hier, sm, b, None, 0.0, ELL_DEVICE_EVERY,
                                ELL_DEVICE_CYCLES, host=host)

    res = run()
    if not time_it:
        return res, hier, plans
    side = ELL_SIDE
    split = {k: round(v, 4) for k, v in hier.setup_seconds.items()}
    ind = ell_rss(res.u, b, side)
    print(f"ell (b) device RAP {side}^2 {levels} levels: dofs "
          f"{[l.A.n_rows for l in hier.levels]}, K "
          f"{[l.A.row_width for l in hier.levels]}, setup {setup:.3f} s "
          f"(rap {split['rap']}, upload {split['upload']}, smoother "
          f"coloring + panels {split['smoother']}, lu {split['lu']})")
    print(f"ell (b) device RAP {side}^2: {res.iterations} V-cycles, rss "
          f"history {res.history}, independent f64 rss {ind:.6e} (the "
          f"flattened transfer coarsens one index only: no convergence "
          f"expected)")
    require(hier.levels[-1].A.n_rows == ELL_DEVICE_COARSEST,
            f"(b) coarsest level {ELL_DEVICE_COARSEST} dofs")
    require(res.iterations == ELL_DEVICE_CYCLES
            and len(res.history) == ELL_DEVICE_CYCLES // ELL_DEVICE_EVERY
            and bool(torch.isfinite(res.u).all())
            and abs(ind - res.error) <= 1e-6 * res.error + 1e-12,
            "(b) fixed V-cycles, finite u, rss checked independently")
    med, walls = wall_median(lambda: run(True), 3)
    _, busy, n_gpu = traced(lambda: run(True))
    g_med, g_walls = wall_median(run, 3)
    print(f"ell (b) device RAP {side}^2 solve wall, a chunk graph a check: "
          f"median of 3 {g_med:.6f} s (all {g_walls}); {card()}")
    print(f"ell (b) device RAP {side}^2 solve wall (host driver): median "
          f"of 3 {med:.6f} s "
          f"(all {walls}), {med / ELL_DEVICE_CYCLES * 1e3:.3f} ms per "
          f"V-cycle, device busy {busy:.6f} s, idle share "
          f"{1 - busy / med:.4f}, GPU launches {n_gpu}")
    return res, hier, plans


def ell_rebuild(dev, A, hier, plans, levels: int):
    """rebuild_hierarchy_values with the fine values scaled by 2.5: equal
    to a fresh device build of the scaled operator, bitwise run to run."""
    scaled = A.data * 2.5

    def rebuild():
        return rebuild_hierarchy_values(hier, plans, scaled)

    rebuild()
    med, _ = wall_median(rebuild, 3)
    h1, h2 = rebuild(), rebuild()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh, _ = build_hierarchy_device(
        ELL(data=scaled, cols=A.cols, shape=A.shape), levels, device=dev)
    torch.cuda.synchronize()
    t_fresh = time.perf_counter() - t0
    rel = max(float((l1.A.data - lf.A.data).abs().max()
                    / lf.A.data.abs().max())
              for l1, lf in zip(h1.levels, fresh.levels))
    bitwise = all(torch.equal(l1.A.data, l2.A.data)
                  and all(torch.equal(x, y) for x, y in zip(
                      l1.smoother_state.data + l1.smoother_state.diag,
                      l2.smoother_state.data + l2.smoother_state.diag))
                  for l1, l2 in zip(h1.levels, h2.levels))
    bitwise = bitwise and torch.equal(h1.coarse.lu, h2.coarse.lu)
    print(f"ell rebuild_hierarchy_values {ELL_SIDE}^2 x 2.5: median of 3 "
          f"{med:.6f} s against a fresh build_hierarchy_device "
          f"{t_fresh:.3f} s; max |rebuild - fresh| / max|fresh| {rel:.3e}, "
          f"bitwise run to run {bitwise}")
    require(rel <= ELL_REBUILD_REL, "rebuild equals a fresh build")
    require(bitwise, "rebuild bitwise equal run to run")


def ell_solves(dev, launches: dict):
    """The reference-parity ELL pipeline through the user entry points,
    plain PyTorch (no kernel of K1-K9): the testlib numbers at 35^2; at
    1023^2 (a) Multigrid with the bilinear transfer (host scipy RAP) to
    1e-9 and (b) the device RAP hierarchy for a fixed 20 V-cycles, and the
    value rebuild; at 255^2 (a) and (b) on the card against the CPU."""

    def body():
        ell_testlib(dev)
        A, b = poisson.poisson2d(ELL_SIDE, device=dev)
        RECORD["ell (a)"] = ell_bilinear(dev, A, b, ELL_SIDE,
                                         ELL_BILINEAR_LEVELS, True).history
        _, hier, plans = ell_device(dev, A, b, ELL_DEVICE_LEVELS, True)
        ell_rebuild(dev, A, hier, plans, ELL_DEVICE_LEVELS)
        del hier, plans
        n = ELL_CHECK_SIDE
        runs, levels = {}, {}
        for d in (dev, "cpu"):
            A, b = poisson.poisson2d(n, device=d)
            res_b, hier, _ = ell_device(d, A, b, ELL_CHECK_DEVICE, False)
            runs[str(d)] = (
                ell_bilinear(d, A, b, n, ELL_CHECK_BILINEAR, False), res_b)
            levels[str(d)] = [lev.A.data.cpu() for lev in hier.levels]
        # the device RAP sums each coarse slot in a fixed order
        same = all(torch.equal(x, y) for x, y in zip(levels[str(dev)],
                                                      levels["cpu"]))
        print(f"ell gpu vs cpu device RAP {n}^2: {len(levels['cpu'])} "
              f"levels bitwise equal {same}")
        require(same, "device RAP levels bitwise equal on the card and CPU")
        for name, rg, rc in zip(("(a) bilinear", "(b) device RAP"),
                                runs[str(dev)], runs["cpu"]):
            g = residual_rounding(A, rc.u, b)
            ok, rel = history_close(rg.history, rc.history, g)
            du = float((rg.u.cpu() - rc.u).abs().max())
            bnd = solution_bound(rg.error, rc.error, n)
            print(f"ell gpu vs cpu {name} {n}^2: V-cycles {rg.iterations} "
                  f"/ {rc.iterations}, rss history {rg.history} / "
                  f"{rc.history}, largest relative difference {rel:.3e}, "
                  f"residual rounding {g:.3e}, max|du| {du:.3e} (bound "
                  f"{bnd:.3e})")
            require(rg.iterations == rc.iterations and ok,
                    f"ell {name} {n}^2: the card's counts and rss history "
                    f"those of the CPU (within {ELL_CARD_CPU_REL} or the "
                    f"residual's rounding)")
            require(du <= bnd, f"ell {name} {n}^2: card and CPU solutions "
                    f"within the residual bound")

    _, c = drive(body, launches)
    require(sum(c.values()) == 0, f"the ELL path launches no kernel: {c}")


def dist_solves(dev, launches: dict):
    """Phase 6: the distributed solve through DistStructuredSolver on
    DIST_SLABS row slabs of the card. At 4095^2, solve_ir_fused with
    halo="rdma" (K7 on every level whose slab holds the G strip rows, 2
    launches per such level per V-cycle) and with "sweep": the same refines
    and a bitwise equal u. One f64 V-cycle at 1023^2 on 8 slabs per halo
    mode: "sweep", "rdma", "overlap" bitwise equal, "step" within 1e-12.
    The card against the CPU at 255^2."""
    side, D = DIST_SIDE, DIST_SLABS
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    results = {}
    for halo in ("rdma", "sweep"):
        t0 = time.perf_counter()
        s = DistStructuredSolver(side, n_devices=D, halo=halo, device=dev,
                                 driver="host")
        setup = time.perf_counter() - t0
        if halo == "rdma":              # dist_graph_solves takes it on
            RECORD["dist rdma solver"] = s
        res, c = drive(lambda: s.solve_ir_fused(b2, tolerance=TOL), launches)
        refines = res.iterations // s.cycles_per_refine
        ind = f64_rss(res.u, b2, side)
        levels = k7_levels(s.cfg) if halo == "rdma" else 0
        print(f"dist solve {side}^2 D={D} halo={halo}: blocks "
              f"{s.cfg.blocks} (n_pad {s.n_pad}), setup {setup:.2f} s, "
              f"refines {refines}, V-cycles {res.iterations}, rss "
              f"{res.error:.6e}, independent f64 rss {ind:.6e}, launches "
              f"{c}")
        require(bool(torch.isfinite(res.u).all())
                and res.u.shape == (side, side),
                f"dist {halo}: finite u of shape ({side}, {side})")
        require(res.error <= TOL and ind <= TOL,
                f"dist {halo} {side}^2 converged to {TOL}")
        require(c["rdma_halo_exchange"] == 2 * levels * res.iterations,
                f"dist {halo}: K7 = 2 x {levels} levels x V-cycles")
        require(sum(n for k, n in off_masked(c).items()
                    if k != "rdma_halo_exchange") == 0,
                f"dist {halo}: no other kernel but K10/K11")
        if halo == "rdma":
            require(levels == 7, "K7 on levels 0-6 (B = 1024 ... 16)")
            med, walls = wall_median(
                lambda: s.solve_ir_fused(b2, tolerance=TOL), 3)
            print(f"dist solve wall {side}^2 D={D} halo=rdma: median of 3 "
                  f"{med:.6f} s (all {walls})")
            w_med, per_card = traced_cards(dist_window(s, b2))
            print(f"dist solve {side}^2 D={D} halo=rdma, one block: "
                  f"{cards_text(w_med, per_card)}")
            save_reference(RECORD["mp_dir"], "rdma", res)
            RECORD[f"dist rdma {side}"] = (res, med)
        results[halo] = (refines, res.u)
        if halo == "sweep":     # dist_const_solves holds "packed" to it
            RECORD[f"dist sweep {side}"] = res
        del s
    require(results["rdma"][0] == results["sweep"][0],
            "rdma and sweep take the same refines")
    require(torch.equal(results["rdma"][1], results["sweep"][1]),
            "rdma and sweep give a bitwise equal u")
    print(f"dist rdma vs sweep {side}^2: same refines, u bitwise equal")
    del results

    side, D = 1023, 8
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    us = {}
    for halo in ("sweep", "rdma", "overlap", "step"):
        s = DistStructuredSolver(side, n_devices=D, dtype=torch.float64,
                                 halo=halo, device=dev, driver="host")
        bp = s.pad_field(b2)
        u, c = drive(lambda: s.unpad(s.vcycle(torch.zeros_like(bp), bp)),
                     launches)
        k7 = 2 * k7_levels(s.cfg) if halo == "rdma" else 0
        require(c["rdma_halo_exchange"] == k7, f"V-cycle {halo}: K7 = {k7}")
        us[halo] = u
    ref = us["sweep"]
    for halo in ("rdma", "overlap"):
        require(torch.equal(us[halo], ref), f"V-cycle {halo} == sweep")
    close = bool(((us["step"] - ref).abs()
                  <= 1e-14 + 1e-12 * ref.abs()).all())
    d, r = rel_err(us["step"], ref)
    print(f"dist V-cycle {side}^2 D={D} f64: rdma, overlap bitwise equal "
          f"to sweep; step max_abs {d:.3e} rel {r:.3e} (rtol 1e-12)")
    require(close, "step within rtol 1e-12 / atol 1e-14 of sweep")

    side, D = 255, 4
    b_cpu = poisson.rhs(side, device="cpu").reshape(side, side)
    r_gpu = DistStructuredSolver(side, n_devices=D, halo="rdma", device=dev,
                                 driver="host"
                                 ).solve_ir_fused(b_cpu.to(dev), TOL)
    r_cpu = DistStructuredSolver(side, n_devices=D, halo="rdma",
                                 device="cpu", driver="host"
                                 ).solve_ir_fused(b_cpu, TOL)
    du = float((r_gpu.u.cpu() - r_cpu.u).abs().max())
    bnd = solution_bound(f64_rss(r_gpu.u.cpu(), b_cpu, side),
                         f64_rss(r_cpu.u, b_cpu, side), side)
    print(f"dist gpu vs cpu {side}^2 D={D}: V-cycles {r_gpu.iterations} / "
          f"{r_cpu.iterations}, max|du| {du:.3e} (bound {bnd:.3e})")
    require(r_gpu.iterations == r_cpu.iterations,
            "dist: same refines on GPU and CPU")
    require(du <= bnd, "dist GPU and CPU solutions within the bound")


def save_reference(out_dir: str, name: str, res) -> None:
    """A one-process run's u, count, rss and history, which the process
    workers hold theirs to (no worker builds the one-block solver again):
    "rdma" (the DIST_SIDE^2 halo="rdma" solve_ir_fused), "rdma_pcg" (its
    f32 PCG), "ell" and "ell_pcg" (EllDistSolver "strips" at ELL_SIDE^2,
    solve and solve_pcg)."""
    np.save(os.path.join(out_dir, f"{name}_u.npy"), res.u.cpu().numpy())
    with open(os.path.join(out_dir, f"{name}_ref.json"), "w") as f:
        json.dump({"iterations": res.iterations, "error": res.error,
                   "history": res.history}, f)


def load_reference(out_dir: str, name: str) -> SimpleNamespace:
    """What save_reference saved: u (a CPU tensor), iterations, error,
    history (a list of tuples)."""
    with open(os.path.join(out_dir, f"{name}_ref.json")) as f:
        ref = json.load(f)
    return SimpleNamespace(
        u=torch.from_numpy(np.load(os.path.join(out_dir, f"{name}_u.npy"))),
        iterations=ref["iterations"], error=ref["error"],
        history=[tuple(h) for h in ref["history"]])


def references(dev, out_dir: str) -> None:
    """save_reference's four runs, one block on ``dev``, for ``--mp`` and
    ``--mp P --cards K``, where the phases that save them do not run."""
    side = DIST_SIDE
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    s = DistStructuredSolver(side, n_devices=DIST_SLABS, halo="rdma",
                             device=dev)
    save_reference(out_dir, "rdma", s.solve_ir_fused(b2, tolerance=TOL))
    save_reference(out_dir, "rdma_pcg", s.solve_pcg(
        b2.to(torch.float32), tolerance=DIST_GRAPH_PCG_TOL))
    A, b = poisson.poisson2d(ELL_SIDE, device=dev)
    e = EllDistSolver(A, b, ELL_BILINEAR_LEVELS, n_devices=ELL_DIST_SLABS,
                      interpolator=BilinearInterpolator2D(ELL_SIDE),
                      halo="strips", device=dev)
    save_reference(out_dir, "ell", e.solve(tolerance=ELL_TOL,
                                           compute_error_every_n_iters=1))
    save_reference(out_dir, "ell_pcg", e.solve_pcg(tolerance=ELL_TOL))
    del s, e
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The rest of the distributed layer: plain PyTorch, no kernel of K1-K9.


def new_path(label: str, run, cycles, setup: float, launches: dict,
             window=None, window_cycles: int = TRACE_CYCLES):
    """One run of a path under drive (K1-K9 must launch 0 times; the masked
    legs K10/K11 may, in a constant hierarchy's replicated coarse
    levels), its wall
    (median of 3) and one traced window (``window``, ``window_cycles``
    V-cycles; None: the run) for the device busy time, the idle share and
    the GPU launches per V-cycle. ``cycles(result)``: the run's V-cycles.
    Returns the run's result."""
    out, c = drive(run, launches)
    require(sum(off_masked(c).values()) == 0,
            f"{label}: K1-K9 launch 0 times: {c}")
    n = cycles(out)
    med, walls = wall_median(run, 3)
    if window is None:
        window, window_cycles, w_med = run, n, med
    else:
        w_med = wall_median(window, 3)[0]
    _, busy, n_gpu = traced(window)
    print(f"{label}: setup {setup:.3f} s, {n} V-cycles, wall median of 3 "
          f"{med:.6f} s (all {walls}), {med / n * 1e3:.3f} ms per V-cycle; "
          f"traced window of {window_cycles} V-cycles: wall {w_med:.6f} s, "
          f"device busy {busy:.6f} s, idle share {1 - busy / w_med:.4f}, "
          f"GPU launches {n_gpu / window_cycles:.1f} per V-cycle")
    return out


def timed_build(make):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = make()
    torch.cuda.synchronize()
    return s, time.perf_counter() - t0


def dist_window(s, b2):
    """TRACE_CYCLES V-cycles from zero of a distributed solver, on every
    block of a card group (s.run), the rhs padded inside."""
    def body(blk):
        bp = blk.pad_field(b2)
        u = torch.zeros_like(bp)
        for _ in range(TRACE_CYCLES):
            u = blk.vcycle(u, bp)
        return u
    return lambda: s.run(body)


def card_against_cpu(dev, make, runs: dict, planes, side: int):
    """The same solves on the card and on the CPU, one solver built on
    each: for each ``label -> run(solver, b)`` of ``runs`` the same count,
    and solutions within the residual bound (the rss by
    f64_rss_planes)."""
    b_cpu = poisson.rhs(side, device="cpu").reshape(side, side)
    solvers = {d: make(d) for d in (dev, "cpu")}
    for label, run in runs.items():
        g, c = (run(s, b_cpu.to(d)) for d, s in solvers.items())
        du = float((g.u.cpu() - c.u).abs().max())
        bnd = solution_bound(f64_rss_planes(g.u.cpu(), b_cpu, planes),
                             f64_rss_planes(c.u, b_cpu, planes), side)
        print(f"{label} gpu vs cpu {side}^2: iterations {g.iterations} / "
              f"{c.iterations}, rss {g.error:.6e} / {c.error:.6e}, max|du| "
              f"{du:.3e} (bound {bnd:.3e})")
        require(g.iterations == c.iterations,
                f"{label}: the same iterations on the card and the CPU")
        require(du <= bnd, f"{label}: card and CPU within the residual "
                "bound")


def dist_var_solves(dev, launches: dict):
    """The jump problem (a = 100) on variable sharded levels: at 4095^2 on
    4 slabs, f64, halo="sweep", solve() to 1e-7 with an independent f64
    rss on the planes; one f64 V-cycle at 1023^2 on 8 slabs, "sweep"
    against "step" (JAX's contract: the same iterates); the card against
    the CPU at 255^2, solve() and the f64 solve_pcg to 1e-9 on one solver
    a device."""
    side, D = DIST_VAR_SIDE, DIST_SLABS
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    s, setup = timed_build(lambda: DistStructuredSolver(
        side, n_devices=D, dtype=torch.float64, halo="sweep",
        A_fine=varcoef.jump_scipy(side), device=dev, driver="host"))
    require(all(w is None for w in s.cfg.w33s),
            "jump: every sharded level variable")
    res = new_path(f"dist var {side}^2 D={D} f64 sweep solve", lambda:
                   s.solve(b2, tolerance=DIST_VAR_TOL),
                   lambda r: r.iterations, setup, launches,
                   dist_window(s, b2))
    ind = f64_rss_planes(res.u, b2, varcoef.jump_planes(
        side, dtype=torch.float64, device=dev))
    print(f"dist var {side}^2 D={D}: blocks {s.cfg.blocks}, sub-hierarchy "
          f"sides {s.sub_hier.sides}, V-cycles {res.iterations}, rss "
          f"history {res.history}, independent f64 rss on the planes "
          f"{ind:.6e}")
    require(bool(torch.isfinite(res.u).all()) and res.u.shape == (side,
                                                                  side),
            f"dist var: finite u of shape ({side}, {side})")
    require(res.converged and abs(ind / res.error - 1) <= 1e-6,
            f"dist var {side}^2 converged to {DIST_VAR_TOL:g}, rss checked "
            "independently")
    RECORD["dist var solver"] = (s, res)   # dist_graph_solves takes it on
    del s, res

    side, D = DIST_VCYCLE_SIDE, DIST_VCYCLE_SLABS
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    us = {}
    for halo in ("sweep", "step"):
        s = DistStructuredSolver(side, n_devices=D, dtype=torch.float64,
                                 halo=halo, A_fine=varcoef.jump_scipy(side),
                                 device=dev, driver="host")
        bp = s.pad_field(b2)
        us[halo], c = drive(lambda: s.unpad(s.vcycle(torch.zeros_like(bp),
                                                     bp)), launches)
        require(sum(c.values()) == 0, f"dist var V-cycle {halo}: no kernel")
    d, r = rel_err(us["step"], us["sweep"])
    print(f"dist var V-cycle {side}^2 D={D} f64: step against sweep max_abs "
          f"{d:.3e} rel {r:.3e}, bitwise equal "
          f"{torch.equal(us['step'], us['sweep'])}")
    require(bool(((us["step"] - us["sweep"]).abs()
                  <= 1e-14 + 1e-12 * us["sweep"].abs()).all()),
            "var step within rtol 1e-12 / atol 1e-14 of sweep")

    side = DIST_CHECK_SIDE
    card_against_cpu(
        dev, lambda d: DistStructuredSolver(
            side, n_devices=DIST_SLABS, dtype=torch.float64, halo="sweep",
            A_fine=varcoef.jump_scipy(side), device=d, driver="host"),
        {"dist var solve": lambda s, b: s.solve(b, tolerance=DIST_CHECK_TOL),
         "dist var pcg f64": lambda s, b: s.solve_pcg(
             b, tolerance=DIST_CHECK_TOL)},
        varcoef.jump_planes(side, dtype=torch.float64, device="cpu"), side)


def dist_const_solves(dev, launches: dict):
    """The constant problem at 4095^2 on 4 slabs with halo="packed" (the
    color steps on packed slabs): solve_ir_fused to 1e-7 against the
    "sweep" solve of phase dist_solves (the same refines, the two u within
    the residual bound, an independent f64 rss); solve_pcg on the same
    solver, f32 to 1e-5 (its iterations beside the single-device
    solve_pcg_device's, the true f64 rss as bench.py prints it, u against
    the df32 solution)."""
    side, D = DIST_SIDE, DIST_SLABS
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    sweep = RECORD.pop(f"dist sweep {side}")
    s, setup = timed_build(lambda: DistStructuredSolver(
        side, n_devices=D, halo="packed", device=dev, driver="host"))
    res = new_path(f"dist packed {side}^2 D={D} solve_ir_fused",
                   lambda: s.solve_ir_fused(b2, tolerance=TOL),
                   lambda r: r.iterations, setup, launches,
                   dist_window(s, b2))
    ind = f64_rss(res.u, b2, side)
    du = float((res.u - sweep.u).abs().max())
    bnd = solution_bound(res.error, sweep.error, side)
    print(f"dist packed {side}^2 D={D}: refines "
          f"{res.iterations // s.cycles_per_refine}, V-cycles "
          f"{res.iterations} (sweep: {sweep.iterations}), rss "
          f"{res.error:.6e} (sweep: {sweep.error:.6e}), independent f64 rss "
          f"{ind:.6e}, max|u - u_sweep| {du:.3e} (bound {bnd:.3e})")
    require(res.error <= TOL and ind <= TOL,
            f"dist packed {side}^2 converged to {TOL}")
    require(res.iterations == sweep.iterations,
            "packed and sweep take the same refines")
    require(du <= bnd, "packed and sweep u within the residual bound")

    b32 = b2.to(torch.float32)
    pcg = new_path(f"dist pcg {side}^2 D={D} f32 halo=packed",
                   lambda: s.solve_pcg(b32, tolerance=PCG_TOL),
                   lambda r: r.iterations + 1, setup, launches,
                   dist_window(s, b32))
    ind = f64_rss(pcg.u.double(), b32.double(), side)
    _, rel_u = rel_err(pcg.u, sweep.u)
    print(f"dist pcg {side}^2 D={D} f32 tol {PCG_TOL:g}: iterations "
          f"{pcg.iterations} (single-device solve_pcg_device, phase "
          f"pcg_solves: {RECORD.get(f'pcg {side}')}), recurrence rss "
          f"{pcg.error:.6e}, true f64 rss {ind:.6e}, max|u - u_df32| / "
          f"max|u_df32| {rel_u:.3e} (u_df32: the sweep solve's; setup: the "
          f"packed solver's)")
    require(bool(torch.isfinite(pcg.u).all()), "dist pcg: finite u")
    require(pcg.converged, f"dist pcg {side}^2 converged to {PCG_TOL:g}")
    # the recurrence rss does not hold the f32 iterate (pcg_solves); the
    # df32 solution does
    require(rel_u <= PCG_REL_U, f"dist pcg {side}^2 within {PCG_REL_U:g} "
            "of the df32 solution")
    del s, res, pcg, sweep


def ell_dist_solves(dev, launches: dict):
    """EllDistSolver on 4 slabs at 1023^2: the bilinear pipeline (9
    levels, f64) to 1e-9 under "step" and "strips", each against the
    single-device Multigrid (a)'s history (phase ell_solves) within the
    residual-rounding rule; its f32 solve_ir to 1e-9 and f64 solve_pcg;
    the flat reference pipeline (12 levels) for 20 V-cycles against the
    single-device Multigrid over the same chain."""
    side, D = ELL_SIDE, ELL_DIST_SLABS
    A, b = poisson.poisson2d(side, device=dev)
    ref = RECORD["ell (a)"]

    def bilinear(halo, dtype=torch.float64):
        return timed_build(lambda: EllDistSolver(
            A, b, ELL_BILINEAR_LEVELS, n_devices=D, dtype=dtype,
            interpolator=BilinearInterpolator2D(side), halo=halo,
            device=dev, driver="host"))

    solvers = {}            # ell_graph_solves takes them on

    def window(s):
        def run():
            bp = s.pad_vec(s.b)
            u = torch.zeros_like(bp)
            for _ in range(TRACE_CYCLES):
                u = s.vcycle_once(u, bp)
            return u
        return run

    for halo in ("step", "strips"):
        s, setup = bilinear(halo)
        label = f"ell dist bilinear {side}^2 D={D} {halo}"
        res = new_path(label, lambda: s.solve(
            tolerance=ELL_TOL, compute_error_every_n_iters=1),
            lambda r: r.iterations, setup, launches, window(s))
        ind = ell_rss(res.u, b, side)
        g = residual_rounding(A, res.u, b)
        ok, rel = history_close(res.history, ref, g)
        print(f"{label}: setup {setup:.3f} s, of it the greedy coloring of "
              f"the 9 levels (native {bindings.available()}; timed in ell "
              f"(a)) {RECORD['ell coloring']:.3f} s, a share "
              f"{RECORD['ell coloring'] / setup:.4f}")
        print(f"{label}: sharded levels {s.Ls} (blocks {s.Bs[:s.Ls]}), "
              f"strip depths {s._ext_meta}, V-cycles {res.iterations}, rss "
              f"history {res.history} (single-device (a): {ref}; largest "
              f"relative difference {rel:.3e}, residual rounding "
              f"{g:.3e}), independent f64 rss {ind:.6e}")
        require(res.converged and abs(ind / res.error - 1) <= 1e-6,
                f"{label}: converged to {ELL_TOL}, rss checked")
        require(res.iterations == ELL_A_CYCLES and ok,
                f"{label}: the single-device (a) history")
        require((s._ext_meta[0] is not None) == (halo == "strips"),
                f"{label}: strips on the fine level iff halo='strips'")
        if halo == "strips":    # card_solves holds its card group to it
            RECORD["ell dist strips"] = res
        if halo == "step":
            pcg = new_path(f"ell dist pcg {side}^2 D={D} f64", lambda:
                           s.solve_pcg(tolerance=ELL_TOL),
                           lambda r: r.iterations + 1, setup, launches,
                           window(s))
            ind = ell_rss(pcg.u, b, side)
            print(f"ell dist pcg {side}^2 D={D} f64: iterations "
                  f"{pcg.iterations}, recurrence rss {pcg.error:.6e}, "
                  f"independent f64 rss {ind:.6e}")
            require(pcg.converged and ind <= 10 * ELL_TOL,
                    "ell dist pcg converged")
        solvers[halo] = s

    s, setup = bilinear("step", torch.float32)
    res = new_path(f"ell dist solve_ir {side}^2 D={D} f32", lambda:
                   s.solve_ir(tolerance=ELL_TOL), lambda r: r.iterations,
                   setup, launches, window(s))
    ind = ell_rss(res.u, b, side)
    print(f"ell dist solve_ir {side}^2 D={D} f32: refines "
          f"{len(res.history) - 1}, V-cycles {res.iterations}, rss history "
          f"{res.history}, independent f64 rss {ind:.6e}")
    # far below the tolerance the f64 check's own rounding is percents of
    # the df32 rss: hold the check to the tolerance
    require(res.converged and ind <= ELL_TOL,
            "ell dist solve_ir converged to 1e-9, rss checked")
    solvers["f32"] = s

    L, n_cyc = ELL_FLAT_LEVELS, ELL_FLAT_CYCLES
    s, setup = timed_build(lambda: EllDistSolver(A, b, L, n_devices=D,
                                                 device=dev, driver="host"))
    res = new_path(f"ell dist flat {side}^2 D={D} {L} levels", lambda:
                   s.solve(tolerance=0.0, compute_error_every_n_iters=5,
                           n_iters=n_cyc),
                   lambda r: r.iterations, setup, launches, window(s))
    single = Multigrid(LinearInterpolator(L), MulticolorGaussSeidel(), A, b,
                       L, 0.0, 5, n_cyc, device=dev).solve(verbose=False)
    g = residual_rounding(A, single.u, b)
    ok, rel = history_close(res.history, single.history, g)
    print(f"ell dist flat {side}^2 D={D}: sharded levels {s.Ls} of {L}, "
          f"sizes {s.sizes}, rss history {res.history}; single-device "
          f"Multigrid {single.history} (the device RAP chain's: 6.46e6, "
          f"6.37e6, 5.97e6, 5.58e6); largest relative difference {rel:.3e}")
    require(res.iterations == n_cyc and ok
            and bool(torch.isfinite(res.u).all()),
            "ell dist flat: the single-device history")
    solvers["flat"] = s
    RECORD["ell dist solvers"] = solvers


# ---------------------------------------------------------------------------
# One process driving several cards: a card group (parallel/launch.py), a
# thread a block. Its timing waits for a thread's stream only (sync).


def card_busy(prof, cycles: int) -> dict:
    """{card: (busy s, GPU launches a V-cycle)} of a trace: the union of
    each card's kernel and copy spans (two blocks on one card overlap),
    NCCL's kernels counted as launches, not as busy time."""
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    out = {}
    for card_, evs in sorted(spans.items()):
        busy, end = 0.0, float("-inf")
        for a, b, name in sorted(evs):
            if name.startswith("nccl") or b <= end:
                continue
            busy += b - max(a, end)
            end = b
        out[card_] = (busy * 1e-6, len(evs) / cycles)
    return out


def traced_cards(fn, reps: int = 3) -> tuple[float, dict]:
    """(wall of ``fn``, a TRACE_CYCLES window, median of ``reps``;
    card_busy of one traced run)."""
    w_med = wall_median(fn, reps)[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return w_med, card_busy(prof, TRACE_CYCLES)


def cards_text(w_med: float, per_card: dict) -> str:
    return (f"traced window of {TRACE_CYCLES} V-cycles: wall {w_med:.6f} s; "
            + "; ".join(f"card {c} busy {b:.6f} s, idle share "
                        f"{1 - b / w_med:.4f}, GPU launches {n:.1f} a "
                        f"V-cycle" for c, (b, n) in per_card.items()))


def _card_peer(dev, cross_card: bool):
    err, lines = peer_parity(dev)
    lines += peer_timeout_check(dev)
    rec, more = peer_timing(dev, cross_card, graph=False)
    rec["max_abs_err"] = err
    return rec, [f"block {launch.process_index()} on {dev}: {line}"
                 for line in lines + more]


def card_peer_checks(devices) -> dict:
    """K7's in-process form in a card group of a block on each of
    ``devices``: every block's parity against the plain version, a lost
    neighbour and per-exchange timing (peer_parity, peer_timeout_check,
    peer_timing without its CUDA graph). Prints every block's lines;
    returns block 0's record."""
    group = launch.CardGroup(devices)
    cross = len(set(devices)) > 1
    try:
        outs = group.run(lambda k: _card_peer(group.devices[k], cross))
    finally:
        group.close()
    for _, lines in outs:
        print("\n".join(f"cards {len(devices)} blocks: {line}"
                        for line in lines))
    rec = dict(outs[0][0], blocks=len(devices),
               cards=len(set(devices)))
    rec["max_abs_err"] = max(r["max_abs_err"] for r, _ in outs)
    return rec


def card_solve(label: str, make, b2, launches: dict, ref=None,
               timed: bool = True, keep: str | None = None):
    """A DistStructuredSolver (``make()``) solve_ir_fused to TOL under drive:
    converged, K7 2 x k7_levels a V-cycle in each block under "rdma" (0
    otherwise), no other kernel; against ``ref`` (the one-block run) the
    same V-cycles, u bitwise, the rss within CARD_RTOL. Then, ``timed``,
    its wall (median of the checked run and two more) and a traced window
    per card; else the checked run's wall alone. Returns (result, K7
    launches)."""
    s, setup = timed_build(make)
    side = s.side
    try:
        t0 = time.perf_counter()
        res, c = drive(lambda: s.solve_ir_fused(b2, tolerance=TOL), launches)
        first = time.perf_counter() - t0
        k7 = (len(s.devices) * 2 * k7_levels(s.cfg) * res.iterations
              if s.cfg.halo == "rdma" else 0)
        require(c["rdma_halo_exchange"] == k7
                and sum(off_masked(c).values()) == c["rdma_halo_exchange"],
                f"{label}: K7 = blocks x 2 x levels x V-cycles ({k7}), no "
                f"other kernel but K10/K11: {c}")
        require(res.error <= TOL and bool(torch.isfinite(res.u).all())
                and res.u.shape == (side, side), f"{label}: converged")
        same = ref is None or torch.equal(res.u, ref.u.to(res.u.device))
        rel = 0.0 if ref is None else abs(res.error / ref.error - 1)
        if ref is not None:
            require(res.iterations == ref.iterations and same
                    and rel <= CARD_RTOL,
                    f"{label}: the one-block V-cycles ({ref.iterations}), u "
                    f"bitwise ({same}), rss within {CARD_RTOL:g} ({rel:.3e})")
        walls, window = [first], "no traced window"
        if timed:
            walls += wall_median(
                lambda: s.solve_ir_fused(b2, tolerance=TOL), 2)[1]
            window = cards_text(*traced_cards(dist_window(s, b2)))
    finally:
        if keep is None:
            s.close()
        else:                           # a later phase takes it on
            RECORD[keep] = s
    per = c["rdma_halo_exchange"] / res.iterations / len(s.devices)
    vs = ("" if ref is None else
          f" (one block {ref.iterations}; u bitwise {same}; rss relative "
          f"difference {rel:.3e})")
    print(f"{label}: blocks on {[str(d) for d in s.devices]}, setup "
          f"{setup:.3f} s, V-cycles {res.iterations}{vs}, rss "
          f"{res.error:.6e}, K7 {c['rdma_halo_exchange']} launches ({per:.0f} "
          f"a V-cycle a block); wall median of {len(walls)} "
          f"{statistics.median(walls):.6f} s (all {walls}); {window}")
    return res, c["rdma_halo_exchange"]


def card_solves(dev, launches: dict):
    """One process, two blocks of a card group on the one card
    (``device=("cuda:0", "cuda:0")``; each block a thread with a stream of
    its own): K7's in-process form (card_peer_checks), then the
    DIST_SIDE^2 D = DIST_SLABS solve under "rdma" and "overlap" against
    dist_solves' one-block "rdma" run ("overlap" untimed: its checked
    run's wall), and EllDistSolver at 1023^2 on 4 slabs under "strips"
    against ell_dist_solves' one-block history (rtol CARD_RTOL, the same
    V-cycles). K7's launches on the "rdma" solve go to the kernels line
    (rdma_halo_exchange_cards)."""
    blocks = (torch.device("cuda", 0),) * CARD_BLOCKS
    rec = card_peer_checks(blocks)
    side, D = DIST_SIDE, DIST_SLABS
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    ref, ref_wall = RECORD[f"dist rdma {side}"]
    print(f"card group 1 card: one block {side}^2 D={D} rdma: V-cycles "
          f"{ref.iterations}, wall median of 3 {ref_wall:.6f} s "
          f"(dist_solves)")
    for halo in ("rdma", "overlap"):
        _, k7 = card_solve(
            f"card group {side}^2 D={D} {halo}, {CARD_BLOCKS} blocks on 1 "
            f"card", lambda: DistStructuredSolver(side, n_devices=D,
                                                  halo=halo, device=blocks,
                                                  driver="host"),
            b2, launches, ref, timed=halo == "rdma",
            keep="card rdma solver" if halo == "rdma" else None)
        if halo == "rdma":
            rec["launches"] = k7
    RECORD["k7_cards"] = rec

    side = ELL_SIDE
    A, b = poisson.poisson2d(side, device=dev)
    ref = RECORD["ell dist strips"]
    s, setup = timed_build(lambda: EllDistSolver(
        A, b, ELL_BILINEAR_LEVELS, n_devices=ELL_DIST_SLABS,
        interpolator=BilinearInterpolator2D(side), halo="strips",
        device=blocks, driver="host"))
    label = (f"card group ell {side}^2 D={ELL_DIST_SLABS} strips, "
             f"{CARD_BLOCKS} blocks on 1 card")

    def window(blk):
        bp = blk.pad_vec(blk.b)
        u = torch.zeros_like(bp)
        for _ in range(TRACE_CYCLES):
            u = blk.vcycle_once(u, bp)
        return u
    def run():
        return s.solve(tolerance=ELL_TOL, compute_error_every_n_iters=1)
    try:
        res, c = drive(run, launches)
        require(sum(c.values()) == 0, f"{label}: no kernel: {c}")
        med, walls = wall_median(run, 3)
        w_med, per_card = traced_cards(lambda: s.run(window))
    except BaseException:
        s.close()
        raise
    RECORD["card ell solver"] = s       # ell_graph_solves takes it on
    got = np.array([e for _, e in res.history])
    want = np.array([e for _, e in ref.history])
    rel = float(np.max(np.abs(got / want - 1)))
    print(f"{label}: setup {setup:.3f} s, V-cycles {res.iterations} (one "
          f"block {ref.iterations}), rss history largest relative "
          f"difference {rel:.3e}; wall median of 3 {med:.6f} s (all "
          f"{walls}); {cards_text(w_med, per_card)}")
    require(res.iterations == ref.iterations and rel <= CARD_RTOL,
            f"{label}: the one-block history within {CARD_RTOL:g}")


def per_block(s, fn) -> list:
    """``fn(block)`` on every block of a distributed solver (the solver
    itself in one block), the results in block order."""
    if s._blocks is None:
        return [fn(s)]
    return s._group.run(lambda k: fn(s._blocks[k]))


def group_dispatch(s, fn) -> list:
    """``fn(block)`` on every block of this process under
    set_sync_debug_mode("error") (a setting of the process: its block 0
    sets it), set once every block's stream is idle and reset once every
    block has dispatched: per block (its result, dispatch seconds,
    whether its work was still running when the call returned)."""
    def body(blk):
        lead = launch.process_index() % len(s.devices) == 0
        torch.cuda.current_stream().synchronize()
        launch.barrier()
        if lead:
            torch.cuda.set_sync_debug_mode("error")
        launch.barrier()
        try:
            t0 = time.perf_counter()
            out = fn(blk)
            disp = time.perf_counter() - t0
        finally:
            launch.barrier()
            if lead:
                torch.cuda.set_sync_debug_mode("default")
            launch.barrier()
        pending = not torch.cuda.current_stream().query()
        torch.cuda.current_stream().synchronize()
        return out, disp, pending
    return per_block(s, body)


def graph_launches(s, name: str) -> list:
    return per_block(s, lambda blk: blk._graphs[name].launches)


def _clone(x):
    return tuple(t.clone() for t in x)


def dist_graph_program(label: str, s, prog: str, run, launches: dict,
                       solve, one=None, busy_parts=None, reps: int = 3):
    """One of DistStructuredSolver's loop programs (``prog``, "ir" or
    "pcg"; ``run(block)`` its device entry point, returning (outputs...,
    stats)) under the graph driver against the host driver of the same
    pieces: every block's outputs and stats bitwise, one graph launch a
    block under set_sync_debug_mode("error"), the launch counts (the
    host's kernels, the condition kernel 1 + passes a block, the peer
    collective over several blocks: a card group, processes, or both);
    then ``solve()`` (the public entry
    point, a SolveResult) against ``one`` (one block's result: u bitwise,
    the same count), its wall (median of ``reps``), and, in one block, the
    device busy time of the loop's pieces (``busy_parts``). Returns the
    public result."""
    cardline = card()
    blocks = len(s.devices)
    spread = blocks * launch.world_size() > 1
    s.set_driver("host")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, hc = drive(lambda: per_block(s, lambda blk: _clone(run(blk))),
                     launches)
    h_wall = time.perf_counter() - t0
    s.set_driver("graph")
    per_block(s, lambda blk: run(blk))            # the graph's first launch
    n0 = graph_launches(s, prog)
    e0 = per_block(s, lambda blk: blk._graphs[prog].execs.clone())
    outs, c = drive(lambda: group_dispatch(
        s, lambda blk: _clone(run(blk))), launches)
    n_graph = [a - b for a, b in zip(graph_launches(s, prog), n0)]
    execs = (per_block(s, lambda blk: blk._graphs[prog].execs.clone())[0]
             - e0[0]).tolist()
    same = all(all(torch.equal(a, b) for a, b in zip(o[0], h))
               for o, h in zip(outs, host))
    disp = max(o[1] for o in outs)
    pending = all(o[2] for o in outs)
    err, it = outs[0][0][-1].tolist()
    it = int(it)
    hc_k = {k: n for k, n in hc.items() if k not in (LOOP, PEER) and n}
    c_k = {k: n for k, n in c.items() if k not in (LOOP, PEER) and n}
    counts_ok = (c_k == hc_k and c[LOOP] == blocks * (1 + it)
                 and (c[PEER] > 0) == spread and hc[PEER] == 0)
    res = solve()
    g_med, g_walls = wall_median(solve, reps)
    vs = ""
    if one is not None:
        vs_ok = (torch.equal(res.u, one.u.to(res.u.device))
                 and res.iterations == one.iterations)
        vs = (f"; one block's u bitwise and {one.iterations} iterations "
              f"{vs_ok}")
        require(vs_ok, f"{label} {prog}: one block's u and count")
    busy_txt = "device busy not measured (a card group, or processes "\
        "sharing a card)"
    busy = None
    if busy_parts is not None:
        busy = pieces_busy(busy_parts, {"pre": execs[0], "post": execs[0],
                                        "body": execs[1], "refine": 0,
                                        "final": 0})
        busy_txt = (f"device busy {busy:.6f} s (the pieces' runs {execs}), "
                    f"idle share {1 - busy / g_med:.4f}; host driver idle "
                    f"share {1 - busy / h_wall:.4f}")
    RECORD[f"dist graph {label} {prog}"] = {
        "it": it, "wall": g_med, "host_wall": h_wall, "busy": busy,
        "dispatch_s": disp, "blocks": blocks, "launches": dict(c)}
    print(f"dist graph {label} {prog}: {blocks} block(s) on "
          f"{[str(d) for d in s.devices]}; passes {it}, rss {err:.6e}, "
          f"outputs and stats bitwise the host driver's {same}, graph "
          f"launches a block {n_graph}, dispatch {disp * 1e3:.3f} ms, "
          f"returned before the work ended {pending}, launches "
          f"{dict(c)} (host driver {hc_k}){vs}; graph wall median of "
          f"{reps} {g_med:.6f} s (all {g_walls}), host driver {h_wall:.6f} s "
          f"(x{h_wall / g_med:.2f}); {busy_txt}; {cardline}")
    require(same, f"{label} {prog}: bitwise the host driver's")
    require(n_graph == [1] * blocks, f"{label} {prog}: one graph launch a "
            "block")
    require(pending, f"{label} {prog}: the call returns before the work "
            "ends")
    require(counts_ok, f"{label} {prog}: launch counts {dict(c)} against "
            f"the host driver's {dict(hc)}")
    return res


def dist_graph_rows(label: str, s, b2, launches: dict, one=None,
                    timed: bool = True, reps: int = 3) -> dict:
    """A constant DistStructuredSolver's rows: capture (``warmup``), then
    solve_ir_device / solve_ir_fused to TOL and the f32 PCG to
    DIST_GRAPH_PCG_TOL (dist_graph_program, walls median of ``reps``),
    against ``one`` (one block's {"ir": result, "pcg": result}) when
    given. Returns the public results."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.set_driver("graph")
    s.warmup()
    torch.cuda.synchronize()
    cap = time.perf_counter() - t0
    print(f"dist graph {label}: capture + instantiate of the five "
          f"programs {cap:.3f} s ({len(s.devices)} block(s))")
    RECORD[f"dist graph {label} capture_s"] = cap
    b32 = b2.to(torch.float32)
    parts = {}
    if s._blocks is None and timed:
        L = s._state()
        for prog in ("ir", "pcg"):
            loop, pre, post = L.loops[prog]
            parts[prog] = pieces(loop, pre, post)
    out = {"ir": dist_graph_program(
        label, s, "ir", lambda blk: blk.solve_ir_device(b2, TOL), launches,
        lambda: s.solve_ir_fused(b2, tolerance=TOL),
        None if one is None else one["ir"], parts.get("ir"), reps)}
    require(out["ir"].converged, f"{label}: converged to {TOL:g}")
    out["pcg"] = dist_graph_program(
        label, s, "pcg", lambda blk: blk.solve_pcg_device(
            b32, DIST_GRAPH_PCG_TOL), launches,
        lambda: s.solve_pcg(b32, tolerance=DIST_GRAPH_PCG_TOL),
        None if one is None else one["pcg"], parts.get("pcg"), reps)
    require(out["pcg"].converged, f"{label}: PCG converged")
    return out


def dist_graph_solve_row(label: str, s, b2, ref, launches: dict):
    """The V-cycle loop (``solve``, JAX's host loop over its ``_vcycle``
    and ``_rss`` programs): one vcycle graph launch a V-cycle under the
    graph driver; u, the count and the rss history bitwise ``ref`` (the
    host driver's run); the dispatch of one V-cycle's launch under
    set_sync_debug_mode("error"); the wall (median of 3)."""
    cardline = card()
    t0 = time.perf_counter()
    s.set_driver("graph")
    s.warmup()
    torch.cuda.synchronize()
    cap = time.perf_counter() - t0
    n0 = graph_launches(s, "vcycle")[0]
    r0 = graph_launches(s, "rss")[0]

    def run():
        return s.solve(b2, tolerance=DIST_VAR_TOL)
    res, c = drive(run, launches)
    n_v = graph_launches(s, "vcycle")[0] - n0
    n_r = graph_launches(s, "rss")[0] - r0
    same = (torch.equal(res.u, ref.u) and res.iterations == ref.iterations
            and res.history == ref.history)
    (_, disp, pending), = group_dispatch(s, lambda blk: blk._go("vcycle"))
    g_med, g_walls = wall_median(run, 3)
    RECORD[f"dist graph {label} solve"] = {
        "it": res.iterations, "wall": g_med, "dispatch_s": disp,
        "capture_s": cap}
    print(f"dist graph {label} solve: capture {cap:.3f} s, V-cycles "
          f"{res.iterations} (host driver {ref.iterations}), vcycle graph "
          f"launches {n_v}, rss launches {n_r}, u, count and rss history "
          f"bitwise the host driver's {same}, one V-cycle's dispatch "
          f"{disp * 1e3:.3f} ms (returned before its work ended "
          f"{pending}), launches {dict(c)}; graph wall median of 3 "
          f"{g_med:.6f} s (all {g_walls}); {cardline}")
    require(same, f"{label} solve: bitwise the host driver's")
    require(n_v == res.iterations and n_r == len(res.history),
            f"{label} solve: one vcycle graph launch a V-cycle")
    require(sum(off_masked(c).values()) == 0,
            f"{label} solve: no kernel but K10/K11: {c}")


def peer_collective_checks(s, where: str = "") -> tuple:
    """The peer collective kernel against its plain version (the host
    collectives: copies between a card group's blocks, torch.distributed
    across processes) on every block of ``s`` in this process (its memory
    from the solver's captures), bitwise, at the main path's payloads:
    the psum of the rss (f64) and of an inner product (f32), the gather of
    the coarse slabs, the one-row halo of the fine level (u) and the G =
    10 strips of the ghost sweep (u and b), then each timed against its
    plain version in turns (plain, kernel, kernel, plain), PEER_REPS
    calls (PEER_REPS_SHARED across processes on one card). The bound: the
    bytes each block reads and writes at the device
    memory's rate, and with the blocks on cards of their own (a machine
    of several cards, where every layout of this script puts them so)
    the bytes it puts to the others over NVLink. Collective: every block
    of the mesh calls it alike. Returns (max_abs_err, (kernel ms, plain
    ms), (bound ms, by), the per-case record) of this process's first
    block, the one-row halo the entry."""
    from amg_tpu_torch.ops.kernels import peer_collective as pc
    cfg = s.cfg
    n, Ls = cfg.sides[0], cfg.n_sharded
    cross = torch.cuda.device_count() > 1
    reps = (PEER_REPS_SHARED if launch.world_size() > 1 and not cross
            else PEER_REPS)

    def body(blk):
        N, k = launch.process_count(), launch.process_index()
        Dl = cfg.n_devices // N
        cases = (("psum f64", (), torch.float64, pc.SUM),
                 ("psum f32", (), torch.float32, pc.SUM),
                 ("gather coarse", (Dl, max(cfg.blocks[Ls - 1] // 2, 1),
                                    cfg.sides[Ls]), torch.float32,
                  pc.GATHER),
                 ("halo 1 row", (2, n), torch.float32, pc.GATHER),
                 ("strips G=10", (2 * 10, 2 * n), torch.float32, pc.GATHER))
        mem, dev = blk._coll, blk.device
        gen = torch.Generator().manual_seed(k)
        rec = {}
        for name, shape, dtype, mode in cases:
            x = torch.randn(shape, generator=gen, dtype=torch.float64
                            ).to(dtype).to(dev)
            plain = ((lambda x=x: launch._gather_host(x)) if mode == pc.GATHER
                     else (lambda x=x: launch._psum_host(x)))

            def kern(x=x, mode=mode):
                return pc.peer_collective(x, mem, mode)
            got, want = kern(), plain()
            sync()
            err = float((got.double() - want.double()).abs().max())
            eq = torch.equal(got, want)
            pms, kms = alternating(plain, kern, reps)
            nbytes = x.numel() * x.element_size()
            moved = N * nbytes + (N * nbytes if mode == pc.GATHER
                                  else nbytes)
            bnd = bound(moved, 0 if mode == pc.GATHER
                        else (N - 1) * x.numel())
            link = (N - 1) * nbytes / NVLINK_BYTES_PER_S * 1e3
            if cross and link > bnd[0]:
                bnd = (link, "bytes")
            rec[name] = dict(equal=eq, err=err, ms=kms, plain_ms=pms,
                             bound=bnd, nbytes=nbytes, block=k)
        sync()
        mem.check()
        return rec
    recs = per_block(s, body)
    cardline = card()
    for rec in recs:
        for name, r in rec.items():
            print(f"peer collective {where}block {r['block']} {name} "
                  f"({r['nbytes']} B a block): bitwise its plain version "
                  f"{r['equal']}, kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
                  f"({r['bound'][1]}); {cardline}")
            require(r["equal"], f"peer collective {name} {where}block "
                    f"{r['block']}: bitwise its plain version")
    main = recs[0]["halo 1 row"]
    err = max(r["err"] for rec in recs for r in rec.values())
    return err, (main["ms"], main["plain_ms"]), main["bound"], recs[0]


def dist_graph_solves(dev, launches: dict):
    """DistStructuredSolver's five JAX programs as CUDA graphs (the graph
    driver) against the host driver of the same pieces: one block of
    DIST_SLABS slabs at DIST_SIDE^2 ("rdma": solve_ir_fused to TOL, the
    f32 PCG; dist_solves' solver), the jump f64 solve of DIST_VAR_SIDE^2
    (20 V-cycles; dist_var_solves' solver and run), and a card group of
    CARD_BLOCKS blocks on the one card ("rdma": card_solves' solver, and
    "sweep"), each bitwise one block's; then the peer collective kernel
    against its plain version."""
    side, D = DIST_SIDE, DIST_SLABS
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    s = RECORD.pop("dist rdma solver")
    one = dist_graph_rows(f"{side}^2 D={D} rdma one block", s, b2, launches)
    save_reference(RECORD["mp_dir"], "rdma_pcg", one["pcg"])
    s.close()
    del s
    sv, ref = RECORD.pop("dist var solver")
    dist_graph_solve_row(f"var {DIST_VAR_SIDE}^2 D={D} f64 sweep", sv,
                         poisson.rhs(DIST_VAR_SIDE, device=dev).reshape(
                             DIST_VAR_SIDE, DIST_VAR_SIDE), ref, launches)
    sv.close()
    del sv, ref
    blocks = (torch.device("cuda", 0),) * CARD_BLOCKS
    s = RECORD.pop("card rdma solver")
    try:
        dist_graph_rows(f"{side}^2 D={D} rdma, {CARD_BLOCKS} blocks on 1 "
                        "card", s, b2, launches, one)
        RECORD["peer_collective"] = peer_collective_checks(s)
    finally:
        s.close()
    s, setup = timed_build(lambda: DistStructuredSolver(
        side, n_devices=D, halo="sweep", device=blocks))
    try:
        print(f"dist graph {side}^2 D={D} sweep, {CARD_BLOCKS} blocks: "
              f"setup {setup:.3f} s")
        dist_graph_rows(f"{side}^2 D={D} sweep, {CARD_BLOCKS} blocks on 1 "
                        "card", s, b2, launches, one, timed=False)
    finally:
        s.close()


def cards_entry(rec: dict) -> dict:
    """The kernels line's entry for K7's in-process form (block 0)."""
    src, replaces = KERNEL_INFO["rdma_halo_exchange"]
    return {"name": "rdma_halo_exchange_cards", "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "blocks": rec["blocks"],
            "cards": rec["cards"], "bound_rate": rec["bound_rate"]}


def cards_only(n: int, graph_rows: bool = False) -> int:
    """``chip_smoke.py --cards N``: one process driving N visible cards
    (a card group, the solvers' default device): K7's in-process form
    between the cards (over NVLink), then DIST_SIDE^2 on D = N (one slab a
    card, JAX's layout) and 2N slabs and CARDS_BIG_SIDE^2 on N, each
    under "rdma" and "overlap" against the one-block "rdma" run on card 0
    (the same V-cycles, u bitwise), with setup, wall, and per card the
    idle share and launches a V-cycle; then the graph driver's rows on
    one block and on the N cards. ``--cards N --graph-rows``: the graph
    rows alone (and the kernels line of the peer collective)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU "
                           "only")
    require(torch.cuda.device_count() >= n,
            f"--cards {n} needs {n} visible cards, "
            f"{torch.cuda.device_count()} seen")
    print(f"card: {card()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    devs = tuple(torch.device("cuda", i) for i in range(n))
    rec = None if graph_rows else card_peer_checks(devs)
    launches = {k: 0 for k in KERNEL_INFO}
    one = torch.device("cuda", 0)
    for side, D in () if graph_rows else ((DIST_SIDE, n), (DIST_SIDE, 2 * n),
                                          (CARDS_BIG_SIDE, n)):
        t0 = time.perf_counter()
        b2 = poisson.rhs(side, device=one).reshape(side, side)
        if side == CARDS_BIG_SIDE:
            s, setup = timed_build(lambda: DistStructuredSolver(
                side, n_devices=D, halo="rdma", driver="host"))
            s.close()
            if setup > CARDS_BIG_SETUP_S:
                print(f"cards {side}^2 D={D}: setup {setup:.1f} s, over "
                      f"{CARDS_BIG_SETUP_S:.0f} s: not run")
                continue
        ref, _ = card_solve(f"cards one block {side}^2 D={D} rdma on card 0",
                            lambda: DistStructuredSolver(
                                side, n_devices=D, halo="rdma", device=one,
                                driver="host"),
                            b2, launches)
        for halo in ("rdma", "overlap"):
            res, k7 = card_solve(
                f"cards {side}^2 D={D} {halo}, {n} cards",
                lambda: DistStructuredSolver(side, n_devices=D, halo=halo,
                                             driver="host"),
                b2, launches, ref)
            if halo == "rdma" and side == DIST_SIDE and D == n:
                rec["launches"] = k7
        print(f"cards {side}^2 D={D}: {time.perf_counter() - t0:.1f} s")
    # the programs as CUDA graphs: one block on card 0, then a block a
    # card (dist_graph_rows), and the peer collective between the cards
    t0 = time.perf_counter()
    side, D = DIST_SIDE, n
    b2 = poisson.rhs(side, device=one).reshape(side, side)
    s = DistStructuredSolver(side, n_devices=D, halo="rdma", device=one)
    ref = dist_graph_rows(f"cards {side}^2 D={D} rdma one block on card 0",
                          s, b2, launches)
    del s
    s = DistStructuredSolver(side, n_devices=D, halo="rdma")
    try:
        dist_graph_rows(f"cards {side}^2 D={D} rdma, {n} cards", s, b2,
                        launches, ref)
        err, (kms, pms), (bms, by), _ = peer_collective_checks(s)
    finally:
        s.close()
    print(f"cards graph rows {side}^2 D={D}: "
          f"{time.perf_counter() - t0:.1f} s")
    src, replaces = KERNEL_INFO[PEER]
    peer = {"name": PEER, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[PEER],
            "max_abs_err": err, "ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "cards": n}
    print(json.dumps({"kernels": ([] if rec is None else [cards_entry(rec)])
                      + [peer]}))
    print(card())
    return 0


def mp_runs(dev, report: bool) -> tuple[dict, list]:
    """The runs the process phase compares: MP_CYCLES f64 V-cycles of
    DistStructuredSolver(MP_SIDE) ("sweep") and of EllDistSolver
    (MP_ELL_SIDE^2, the flat pipeline, "step") on MP_SLABS slabs, the rss
    after each and the gathered field. Returns (arrays, report lines: with
    ``report`` the setup, wall of the run, median of 3, and a traced
    run; where the processes share one card a median of 1, the whole
    script's time being bounded)."""
    out, lines = {}, []
    reps = 3 if torch.cuda.device_count() >= launch.world_size() else 1
    b2 = poisson.rhs(MP_SIDE, device=dev).reshape(MP_SIDE, MP_SIDE)
    A, b = poisson.poisson2d(MP_ELL_SIDE, device=dev)
    cases = (("dist", lambda: DistStructuredSolver(
        MP_SIDE, n_devices=MP_SLABS, dtype=torch.float64, halo="sweep",
        device=dev, driver="host"), lambda s: (s.pad_field(b2), s.vcycle,
                                               s.rss, s.unpad)),
             ("ell", lambda: EllDistSolver(A, b, MP_ELL_LEVELS,
                                           n_devices=MP_SLABS, device=dev,
                                           driver="host"),
              lambda s: (s.pad_vec(s.b), s.vcycle_once, s.rss,
                         s.unpad_vec)))
    for name, make, parts in cases:
        s, setup = timed_build(make)
        bp, vc, rss, gather = parts(s)

        def run(n=MP_CYCLES):
            u, hist = torch.zeros_like(bp), []
            for _ in range(n):
                u = vc(u, bp)
                hist.append(rss(u, bp))
            return np.array(hist), gather(u).cpu().numpy()

        out[name + "_rss"], out[name + "_u"] = run()
        if not report:
            continue
        med, walls = wall_median(run, reps)
        w_med = wall_median(lambda: run(TRACE_CYCLES), reps)[0]
        _, busy, n_gpu = traced(lambda: run(TRACE_CYCLES))
        lines.append(f"{name}: setup {setup:.3f} s, {MP_CYCLES} V-cycles "
                     f"wall median of {reps} {med:.6f} s (all {walls}); traced "
                     f"window of {TRACE_CYCLES} V-cycles: wall {w_med:.6f} "
                     f"s, device busy {busy:.6f} s, idle share "
                     f"{1 - busy / w_med:.4f}, GPU launches "
                     f"{n_gpu / TRACE_CYCLES:.1f} per V-cycle")
    return out, lines


def peer_parity(dev) -> tuple[float, list]:
    """K7's peer form against its plain version (launch.strips), bitwise,
    in f32 and f64 at PEER_SHAPES: every process makes the whole line's u
    and b from one seed, exchanges its own slabs PEER_EPOCHS times with new
    values (both receive slots, one of them twice), and holds the strips
    to the plain version and that to the one-process exchange of the
    whole line. Returns max_abs_err and the report lines."""
    err, lines = 0.0, []
    for D, B, n, G in PEER_SHAPES:
        mesh = launch.device_mesh_1d(D)
        Dl = mesh.slabs_per_process
        for dtype in (torch.float32, torch.float64):
            strips = launch.open_peer_strips([(Dl, G, 2 * n)], dtype)
            g = torch.Generator(device=dev).manual_seed(D * B + n)
            same = True
            for _ in range(PEER_EPOCHS):
                u, b = (torch.randn((D, B, n), generator=g, device=dev,
                                    dtype=dtype) for _ in range(2))
                part = (mesh.local(u), mesh.local(b))
                got = rdma_halo_exchange_peer(part, G,
                                              strips[(Dl, G, 2 * n)])
                ref = launch.strips(torch.cat(part, dim=2), G)
                whole = mesh.local(rdma_halo_exchange_plain((u, b), G))
                same &= torch.equal(got, ref) and torch.equal(ref, whole)
                err = max(err, float((got - ref).abs().max()))
            launch.close_peer_strips(strips)
            lines.append(f"parity K7 peer D={D} ({Dl} here) B={B} n={n} "
                         f"G={G} {dtype}, {PEER_EPOCHS} exchanges: bitwise "
                         f"equal to the plain version and to the "
                         f"one-process exchange {same}")
            require(same, f"K7 peer D={D} n={n} {dtype} bitwise equal")
    return err, lines


def peer_timeout_check(dev) -> list:
    """A lost neighbour ends the wait: process 0 exchanges alone on strips
    whose bound is PEER_TIMEOUT_TEST_S. Its launch ends, its next call
    raises, and so does its close; the other processes only close."""
    key = (1, 2, 8)
    strips = launch.open_peer_strips([key], torch.float32,
                                     timeout_s=PEER_TIMEOUT_TEST_S)
    if launch.process_index() != 0:
        launch.close_peer_strips(strips)
        return []
    x = torch.zeros((1, 4, 8), device=dev)
    t0 = time.perf_counter()
    rdma_halo_exchange_peer(x, 2, strips[key])
    torch.cuda.synchronize()
    waited = time.perf_counter() - t0
    msgs = []
    for fn in (lambda: rdma_halo_exchange_peer(x, 2, strips[key]),
               lambda: launch.close_peer_strips(strips)):
        try:
            fn()
            msgs.append(None)
        except RuntimeError as exc:
            msgs.append(str(exc))
    require(all(m is not None and "timed out" in m for m in msgs)
            and PEER_TIMEOUT_TEST_S <= waited < 30,
            f"a lost neighbour: the wait ends after {PEER_TIMEOUT_TEST_S} "
            f"s and raises ({waited:.3f} s, {msgs})")
    return [f"K7 peer, neighbour lost: the launch returned after "
            f"{waited:.3f} s (bound {PEER_TIMEOUT_TEST_S} s); the next call "
            f"and close raised: {msgs[0]!r}"]


def peer_timing(dev, cross_card: bool, graph: bool = True
                ) -> tuple[dict, list]:
    """K7's peer form at the path's shape (PEER_SHAPES[0], f32, u and b
    apart, this block's slabs), per exchange (CUDA events, 50 launches)
    against its plain version (launch.strips: launch.edges and the local
    shift) and against the library's exchange alone (launch.edges: one
    batch of torch.distributed send/recv across processes, copies between
    the cards in a card group), in turns (plain, kernel, library,
    library, kernel, plain; the better of each pair); then, with
    ``graph``, its device time, one launch in a CUDA graph of
    K7_GRAPH_LAUNCHES replayed (every process replays alike; not in a
    card group, where a capture would stop the other threads' work). The
    bound: the strips this block reads and writes at the device memory's
    rate and, with its neighbours on other cards (``cross_card``), its
    end strips over NVLink."""
    D, B, n, G = PEER_SHAPES[0]
    Dl = launch.device_mesh_1d(D).slabs_per_process
    W, key = 2 * n, (Dl, G, 2 * n)
    g = torch.Generator(device=dev).manual_seed(7 + launch.process_index())
    u, b = (torch.randn((Dl, B, n), generator=g, device=dev)
            for _ in range(2))
    x = torch.cat([u, b], dim=2).reshape(Dl * B, W)
    strips = launch.open_peer_strips([key], torch.float32)
    st = strips[key]

    def kern():
        return rdma_halo_exchange_peer((u, b), G, st)

    def plain():
        return launch.strips(torch.cat([u, b], dim=2), G)

    def lib():
        return launch.edges(x, G, 0)
    ref = plain()
    require(torch.equal(kern(), ref), "K7 peer equals the plain version")
    order = ((plain, 10), (kern, 50), (lib, 10))
    first = [time_ms(fn, reps) for fn, reps in order]
    second = [time_ms(fn, reps) for fn, reps in order[::-1]][::-1]
    pms, kms, lms = (min(a, b) for a, b in zip(first, second))
    device_ms = peer_graph_ms(kern, st, ref) if graph else None
    launch.close_peer_strips(strips)

    r, P = launch.process_index(), launch.process_count()
    ends = (r == 0) + (r == P - 1)       # strips zero-filled, not read
    strip = G * W * u.element_size()
    moved = (2 * Dl - ends + 2 * Dl) * strip
    t_mem = moved / HBM_BYTES_PER_S * 1e3
    t_link = ((2 - ends) * strip / NVLINK_BYTES_PER_S * 1e3 if cross_card
              else 0.0)
    bnd = max(t_mem, t_link)
    rate = ("NVLink 450 GB/s each way" if t_link > t_mem
            else "HBM 3.35 TB/s")
    size = f"D={D} ({Dl} here) B={B} n={n} G={G}"
    rec = dict(ms=kms, plain_ms=pms, library_ms=lms, device_ms=device_ms,
               bound_ms=bnd, bound_by="bytes", bound_rate=rate, bytes=moved)
    if not launch.in_card_group():
        lib = torch.distributed.get_backend()
    elif launch.world_size() > 1:
        lib = (f"copies between the blocks' cards and the lead's "
               f"{torch.distributed.get_backend()} send/recv")
    else:
        lib = "copies between the blocks' cards"
    graph_txt = (f"; device {device_ms:.5f} ms a launch in a CUDA graph of "
                 f"{K7_GRAPH_LAUNCHES}" if graph else "")
    return rec, [
        f"time K7 peer {size}: per exchange {kms:.4f} ms against the plain "
        f"version {pms:.4f} ms and the library's exchange alone "
        f"(launch.edges, {lib}) {lms:.4f} ms, in turns{graph_txt}; bound "
        f"{bnd:.5f} ms ({moved / 1e6:.2f} MB, {rate})"]


def peer_graph_ms(kern, st, ref) -> float:
    """K7's peer form's device time: one launch in a CUDA graph of
    K7_GRAPH_LAUNCHES replayed, the better of two runs of 10 replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(K7_GRAPH_LAUNCHES):
            kern()
    st.out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(st.out, ref), "K7 peer's graph replay writes the "
            "strips")
    return min(time_ms(graph.replay, 10),
               time_ms(graph.replay, 10)) / K7_GRAPH_LAUNCHES


def peer_rdma_solve(dev, out_dir: str) -> tuple[dict, list, object]:
    """The DIST_SIDE^2 D = DIST_SLABS halo="rdma" solve_ir_fused to TOL
    across the processes under the host driver (the host row): K7 (its
    peer form) 2 x 7 levels a V-cycle, no other kernel, the one-process
    run's V-cycles and a bitwise equal u (save_reference "rdma"), an
    independent f64 rss; the checked run's wall and a traced window of
    TRACE_CYCLES V-cycles. Returns (record, lines, the solver: the graph
    rows take it on, proc_graph_rows)."""
    side, D = DIST_SIDE, DIST_SLABS
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    s, setup = timed_build(lambda: DistStructuredSolver(
        side, n_devices=D, halo="rdma", device=dev, driver="host"))
    launches = {k: 0 for k in KERNEL_INFO}
    t0 = time.perf_counter()
    res, c = drive(lambda: s.solve_ir_fused(b2, tolerance=TOL), launches)
    first = time.perf_counter() - t0
    levels = k7_levels(s.cfg)
    ref = load_reference(out_dir, "rdma")
    ind = f64_rss(res.u, b2, side)
    same = torch.equal(res.u.cpu(), ref.u)
    require(levels == 7 and c["rdma_halo_exchange"]
            == 2 * levels * res.iterations,
            f"K7 = 2 x 7 levels x V-cycles in each process: {c}")
    require(sum(n for k, n in c.items() if k != "rdma_halo_exchange") == 0,
            "rdma across processes: no other kernel")
    require(res.error <= TOL and ind <= TOL, f"converged to {TOL}")
    require(res.iterations == ref.iterations and same,
            "the one-process V-cycles and a bitwise equal u")
    med = first
    window = dist_window(s, b2)
    w_med = wall_median(window, 3)[0]
    _, busy, n_gpu = traced(window)
    per = c["rdma_halo_exchange"] / res.iterations
    rec = dict(launches=c["rdma_halo_exchange"], vcycles=res.iterations,
               wall=med, idle=1 - busy / w_med)
    return rec, [
        f"rdma {side}^2 D={D}: setup {setup:.3f} s, V-cycles "
        f"{res.iterations} (one process {ref.iterations}), rss "
        f"{res.error:.6e}, independent f64 rss {ind:.6e}, u bitwise equal "
        f"to one process's {same}, K7 {c['rdma_halo_exchange']} launches "
        f"({per:.0f} a V-cycle); wall of the checked run {med:.6f} s; "
        f"traced window of {TRACE_CYCLES} V-cycles: wall "
        f"{w_med:.6f} s, device busy {busy:.6f} s, idle share "
        f"{1 - busy / w_med:.4f}, GPU launches {n_gpu / TRACE_CYCLES:.1f} "
        f"per V-cycle"], s


def ell_strips(device):
    """EllDistSolver at ELL_SIDE^2 on ELL_DIST_SLABS slabs, the bilinear
    pipeline under "strips" (f64), on ``device`` (a card, or a process's
    card group) under the host driver (the host rows; proc_graph_rows
    turns the graph driver on), and its setup seconds."""
    A, b = poisson.poisson2d(ELL_SIDE, device=device[0] if isinstance(
        device, tuple) else device)
    return timed_build(lambda: EllDistSolver(
        A, b, ELL_BILINEAR_LEVELS, n_devices=ELL_DIST_SLABS,
        interpolator=BilinearInterpolator2D(ELL_SIDE), halo="strips",
        device=device, driver="host"))


def proc_graph_rows(s, e, out_dir: str, where: str, timed: bool) -> dict:
    """The distributed programs as CUDA graphs across the processes of
    this process group (ROADMAP 6c step 3), inside a worker, on the
    solvers of its host rows (``s``: DistStructuredSolver DIST_SIDE^2 D
    = DIST_SLABS "rdma"; ``e``: EllDistSolver ELL_SIDE^2 "strips"; a block
    a process, or the process's card group in the mesh), each against
    the host driver of the same processes and the one-process runs that
    save_reference left in ``out_dir``: solve_ir_fused to TOL and the f32
    solve_pcg to DIST_GRAPH_PCG_TOL (dist_graph_rows: capture; outputs,
    counts and stats bitwise the host driver's; one graph launch a
    program a block under set_sync_debug_mode("error"); the launch counts,
    K7 2 x 7 a V-cycle a block and the peer collective; the one process's
    u bitwise and count; an independent f64 rss; the PCG's u within
    PCG_REL_U of the df32 one), ``e``'s solve (ell_graph_row) and
    solve_pcg (dist_graph_program), each u, count and history bitwise the
    one process's; walls, dispatch, capture and, with ``timed`` (a card a
    process), the pieces' busy time and the idle share beside the host
    driver's (walls median of 3; of 1 where processes share the card:
    correctness rows there, each round trip a context switch). Then the
    peer collective kernel against its plain version at the path's
    payloads (peer_collective_checks). Collective: every process calls
    it alike. Returns this process's record: the peer
    collective's numbers (its first block's) and its launches on these
    rows."""
    side, D = DIST_SIDE, DIST_SLABS
    dev = s.devices[0]
    blocks = len(s.devices)
    b2 = poisson.rhs(side, device=dev).reshape(side, side)
    launches = {k: 0 for k in KERNEL_INFO}
    t0 = time.perf_counter()
    ir_ref, pcg_ref = (load_reference(out_dir, n)
                       for n in ("rdma", "rdma_pcg"))
    label = f"{where} {side}^2 D={D} rdma"
    reps = 3 if timed else 1
    out = dist_graph_rows(label, s, b2, launches,
                          {"ir": ir_ref, "pcg": pcg_ref}, timed=timed,
                          reps=reps)
    levels = k7_levels(s.cfg)
    for prog in out:
        rec = RECORD[f"dist graph {label} {prog}"]
        v = rec["it"] * s.cycles_per_refine if prog == "ir" else rec["it"] + 1
        k7 = rec["launches"].get("rdma_halo_exchange", 0)
        require(levels == 7 and k7 == blocks * 2 * levels * v,
                f"{label} {prog}: K7 = blocks x 2 x 7 levels x V-cycles: "
                f"{rec['launches']}")
    ir, pcg = out["ir"], out["pcg"]
    ind = f64_rss(ir.u, b2, side)
    ind_pcg = f64_rss(pcg.u.double(), b2, side)
    _, rel_u = rel_err(pcg.u, ir_ref.u.to(pcg.u.device))
    print(f"dist graph {label}: solve_ir_fused independent f64 rss "
          f"{ind:.6e}; PCG true f64 rss {ind_pcg:.6e}, max|u - u_df32| / "
          f"max|u_df32| {rel_u:.3e}; K7 2 x {levels} levels a V-cycle a "
          f"block; {card()}")
    require(ind <= TOL, f"{label}: the independent f64 rss within {TOL}")
    require(rel_u <= PCG_REL_U, f"{label} PCG within {PCG_REL_U:g} of the "
            "df32 solution")

    elabel = f"{where} ell {ELL_SIDE}^2 D={ELL_DIST_SLABS} strips"
    ref = load_reference(out_dir, "ell")
    res = ell_graph_row(f"{elabel} solve", e, lambda e: e.solve(
        tolerance=ELL_TOL, compute_error_every_n_iters=1),
        ell_solve_counts, launches, timed=timed, reps=reps)
    same = (torch.equal(res.u, ref.u.to(res.u.device))
            and (res.iterations, res.error, res.history)
            == (ref.iterations, ref.error, ref.history))
    print(f"stepped graph {elabel} solve: one process's u, count, rss and "
          f"history bitwise {same}")
    require(same, f"{elabel} solve: one process's, bitwise")
    parts = (pieces(*e._state().loops["pcg"])
             if timed and e._blocks is None else None)
    pcg = dist_graph_program(
        f"{elabel} f64", e, "pcg", lambda blk: ell_pcg_device(
            blk, ELL_TOL, 100), launches,
        lambda: e.solve_pcg(tolerance=ELL_TOL),
        load_reference(out_dir, "ell_pcg"), parts, reps)
    ind = ell_rss(pcg.u, e.b, ELL_SIDE)
    print(f"dist graph {elabel} f64 pcg: independent f64 rss {ind:.6e}")
    require(pcg.converged and ind <= 10 * ELL_TOL,
            f"{elabel} pcg converged")
    err, (kms, pms), (bms, by), cases = peer_collective_checks(
        s, f"{where} ")
    print(f"dist graph {where}: the graph rows and the peer collective "
          f"checks {time.perf_counter() - t0:.1f} s")
    return dict(max_abs_err=err, ms=kms, plain_ms=pms, bound_ms=bms,
                bound_by=by, launches=launches[PEER],
                by_case={c: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                             "bound_ms": r["bound"][0]}
                         for c, r in cases.items()})


def mesh_solves(blocks, out_dir: str) -> tuple[dict, list]:
    """The mesh of this process group's processes x ``blocks`` (a card
    group in each process, parallel/launch.py), inside a worker of the
    process group: K7's peer form on every block (peer_parity, a lost
    neighbour, per-exchange timing: ``_card_peer``; its neighbours a
    block of this process and one of the next), the DIST_SIDE^2 D =
    DIST_SLABS "rdma" solve_ir_fused under the host driver once against
    the one-block run (save_reference: the same V-cycles, u bitwise; K7
    2 x k7_levels a V-cycle a block; an independent f64 rss; the checked
    run's wall and a traced window per card), and EllDistSolver
    "strips" at ELL_SIDE^2 under the host driver against the one-block
    history within CARD_RTOL; then both solvers' programs as CUDA graphs
    (proc_graph_rows, the peer collective across the mesh). Returns
    (block 0's K7 record, with the graph rows' peer collective record
    under "peer_collective", the report lines)."""
    t_phase = time.perf_counter()
    r, P = launch.world_rank(), launch.world_size()
    cross = len(set(blocks)) > 1
    group = launch.CardGroup(blocks)
    try:
        outs = group.run(lambda k: _card_peer(group.devices[k], cross))
    finally:
        group.close()
    lines = [line for _, block_lines in outs for line in block_lines]
    rec = dict(outs[0][0], processes=P, blocks=P * len(blocks),
               cards=len(set(blocks)))
    rec["max_abs_err"] = max(o["max_abs_err"] for o, _ in outs)

    side, D = DIST_SIDE, DIST_SLABS
    b2 = poisson.rhs(side, device=blocks[0]).reshape(side, side)
    ref = load_reference(out_dir, "rdma")
    s, setup = timed_build(lambda: DistStructuredSolver(
        side, n_devices=D, halo="rdma", device=blocks, driver="host"))
    e = None
    launches = {k: 0 for k in KERNEL_INFO}
    try:
        t0 = time.perf_counter()
        res, c = drive(lambda: s.solve_ir_fused(b2, tolerance=TOL), launches)
        wall = time.perf_counter() - t0
        levels = k7_levels(s.cfg)
        ind = f64_rss(res.u, b2, side)
        same = torch.equal(res.u.cpu(), ref.u)
        k7 = c["rdma_halo_exchange"]
        require(levels == 7 and k7 == len(blocks) * 2 * levels
                * res.iterations and sum(off_masked(c).values()) == k7,
                f"mesh rdma: K7 = blocks x 2 x 7 levels x V-cycles, no other "
                f"kernel: {c}")
        require(res.error <= TOL and ind <= TOL
                and res.u.shape == (side, side), f"mesh rdma converged to "
                f"{TOL}")
        require(res.iterations == ref.iterations and same,
                "mesh rdma: the one-block V-cycles and a bitwise equal u")
        # one window where the processes share the card (see mp_runs)
        w_med, per_card = traced_cards(dist_window(s, b2),
                                       3 if cross or P == 1 else 1)
        rec.update(launches=k7, vcycles=res.iterations, wall=wall)
        lines.append(
            f"mesh rdma {side}^2 D={D}, {P} processes x {len(blocks)} blocks "
            f"on {[str(d) for d in blocks]}: setup {setup:.3f} s, V-cycles "
            f"{res.iterations} (one block {ref.iterations}), rss "
            f"{res.error:.6e}, independent f64 rss {ind:.6e}, u bitwise "
            f"equal to one block's {same}, K7 {k7} launches in this process "
            f"({k7 / len(blocks) / res.iterations:.0f} a V-cycle a block); "
            f"wall of the checked run {wall:.6f} s; "
            f"{cards_text(w_med, per_card)}")

        ref = load_reference(out_dir, "ell")
        e, setup = ell_strips(blocks)
        t0 = time.perf_counter()
        res, c = drive(lambda: e.solve(tolerance=ELL_TOL,
                                       compute_error_every_n_iters=1),
                       launches)
        wall = time.perf_counter() - t0
        got = np.array([h[1] for h in res.history])
        want = np.array([h[1] for h in ref.history])
        rel = (float(np.max(np.abs(got / want - 1)))
               if got.shape == want.shape else float("inf"))
        lines.append(
            f"mesh ell {ELL_SIDE}^2 D={ELL_DIST_SLABS} strips, {P} processes "
            f"x {len(blocks)} blocks: setup {setup:.3f} s, V-cycles "
            f"{res.iterations} (one block {ref.iterations}), rss history "
            f"largest relative difference {rel:.3e}; wall of the checked run "
            f"{wall:.6f} s")
        require(sum(c.values()) == 0, f"mesh ell: no kernel: {c}")
        require(res.iterations == ref.iterations and rel <= CARD_RTOL,
                f"mesh ell: the one-block history within {CARD_RTOL:g}")
        rec["peer_collective"] = proc_graph_rows(
            s, e, out_dir, f"mesh {P}x{len(blocks)} rank {r}",
            timed=False)
    finally:
        s.close()
        if e is not None:
            e.close()
    lines.append(f"phase mesh_solves (process {r}): "
                 f"{time.perf_counter() - t_phase:.1f} s")
    return rec, [f"mesh rank {r}/{P}: {line}" for line in lines]


def mesh_entry(rec: dict) -> dict:
    """The kernels line's entry for K7's mesh form (block 0 of process
    0: per-exchange ms; launches on the mesh's "rdma" solve, both blocks
    of process 0)."""
    src, replaces = KERNEL_INFO["rdma_halo_exchange"]
    return {"name": "rdma_halo_exchange_mesh", "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "processes": rec["processes"],
            "blocks": rec["blocks"], "cards": rec["cards"],
            "bound_rate": rec["bound_rate"]}


def proc_peer_entry(rec: dict, name: str, **where) -> dict:
    """The kernels line's entry for the peer collective across processes
    (``name``: its form; process 0's first block: the one-row halo's ms a
    call, its plain version's, its bound; the process's launches on the
    graph rows; the other payloads under ``by_case``)."""
    src, replaces = KERNEL_INFO[PEER]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, **where,
            "by_case": rec["by_case"]}


def mesh_worker(rank: int, world: int, port: int, out_dir: str,
                k: int) -> None:
    """One process of ``--mp P --cards K`` (``chip_smoke.py
    --mesh-worker``): its K cards (initialize_distributed, nccl), the
    mesh phase alone."""
    launch.initialize_distributed(f"localhost:{port}", world, rank,
                                  local_devices=k)
    rec, lines = mesh_solves(launch.local_cards(), out_dir)
    print("\n".join(lines))
    with open(os.path.join(out_dir, f"mesh{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def mesh_only(n_procs: int, k: int) -> int:
    """``chip_smoke.py --mp P --cards K``: the mesh phase alone on P·K
    cards, P processes of K each (nccl; K7 and the peer collective by
    peer access between the cards of a process, through CUDA IPC
    across), against the one-block runs on card 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU "
                           "only")
    require(torch.cuda.device_count() >= n_procs * k,
            f"--mp {n_procs} --cards {k} needs {n_procs * k} visible cards, "
            f"{torch.cuda.device_count()} seen")
    print(f"card: {card()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as out_dir:
        references(dev, out_dir)
        texts = spawn_workers("--mesh-worker", n_procs, out_dir, str(k))
        for rank, text in enumerate(texts):
            print("\n".join(line for line in text.splitlines()
                            if line.startswith(RELAYED)))
        with open(os.path.join(out_dir, "mesh0.json")) as f:
            rec = json.load(f)
    print(json.dumps({"kernels": [
        mesh_entry(rec), proc_peer_entry(
            rec["peer_collective"], "peer_collective_mesh",
            processes=n_procs, blocks=n_procs * k, cards=n_procs * k)]}))
    print(card())
    return 0


# the worker lines the parent prints
RELAYED = ("mp rank", "mesh rank", "dist graph", "stepped graph",
           "peer collective")


def spawn_workers(flag: str, n_procs: int, out_dir: str, *extra) -> list:
    """``chip_smoke.py FLAG RANK n_procs PORT out_dir [extra]`` for every
    rank, all at once; their outputs. Raises if one fails or they do not
    finish in MP_TIMEOUT."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(rank),
         str(n_procs), str(port), out_dir, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n_procs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"workers did not finish in {MP_TIMEOUT} s")
    print(f"{flag} workers: {time.perf_counter() - t0:.1f} s from spawn to "
          f"exit (start, CUDA context, setup, runs)")
    for rank, (p, text) in enumerate(zip(procs, outs)):
        require(p.returncode == 0,
                f"{flag} worker {rank} failed:\n{text[-3000:]}")
    return outs


def mp_worker(rank: int, world: int, port: int, out_dir: str) -> None:
    """One process of the process phase (``chip_smoke.py --mp-worker``):
    the plain paths (no kernel), then K7's peer form (parity, a lost
    neighbour, timing), the halo="rdma" solve under the host driver, and
    the distributed programs as CUDA graphs across the processes
    (proc_graph_rows: the "rdma" solver's, then EllDistSolver "strips"
    at ELL_SIDE^2)."""
    launch.initialize_distributed(f"localhost:{port}", world, rank)
    dev = torch.device("cuda")
    K.reset_launch_counts()
    out, lines = mp_runs(dev, report=True)
    counts = K.launch_counts()
    require(sum(off_masked(counts).values()) == 0,
            f"mp rank {rank}: no kernel but K10/K11")
    err, more = peer_parity(dev)
    lines += more + peer_timeout_check(dev)
    rec, more = peer_timing(dev, torch.cuda.device_count() >= world)
    lines += more
    solve, more, s = peer_rdma_solve(dev, out_dir)
    lines += more
    rec.update(solve, max_abs_err=err)
    for line in lines:
        print(f"mp rank {rank}/{world} ({torch.distributed.get_backend()} "
              f"on card {torch.cuda.current_device()}, "
              f"{launch.device_mesh_1d(MP_SLABS).slabs_per_process} of "
              f"{MP_SLABS} slabs) {line}")
    e = None
    try:
        e, setup = ell_strips(dev)
        print(f"mp rank {rank}/{world}: ell {ELL_SIDE}^2 strips setup "
              f"{setup:.3f} s")
        # busy time only with a card a process: processes that share one
        # time-slice it
        rec["peer_collective"] = proc_graph_rows(
            s, e, out_dir, f"{world} processes rank {rank}",
            timed=torch.cuda.device_count() >= world)
    finally:
        s.close()
        if e is not None:
            e.close()
    del s, e
    if (world == MESH_PROCS and torch.cuda.device_count() == 1
            and os.path.exists(os.path.join(out_dir, "mesh.flag"))):
        # the mesh (the whole script's run): this process's blocks on the
        # one card
        rec["mesh"], lines = mesh_solves(
            (torch.device("cuda", 0),) * MESH_BLOCKS, out_dir)
        print("\n".join(lines))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def mp_solves(dev, launches: dict, n_procs: int = MP_PROCS):
    """``n_procs`` processes, each holding MP_SLABS / n_procs slabs, against
    one process holding all: the same rss after each V-cycle and the same
    gathered field within rtol 1e-12 (only the order of the sums differs).
    On one card the processes share it under gloo: the launch path
    (initialize_distributed, send/recv of the edge strips, all_gather),
    not NCCL; with a card a process they take nccl. The
    workers report the walls; the one process is the reference only. Each
    worker also checks K7's peer form, runs the halo="rdma" solve against
    the one-process runs that the earlier phases (or references) saved in
    RECORD["mp_dir"], and the programs as CUDA graphs across the
    processes (proc_graph_rows); rank 0's K7 numbers go to
    RECORD["k7_peer"], with its peer collective's under
    "peer_collective". In the whole script's run (2 processes, one card)
    each worker then runs the mesh of 2 x MESH_BLOCKS blocks
    (mesh_solves); process 0's block 0 K7 numbers go to
    RECORD["k7_mesh"]."""
    cards = torch.cuda.device_count()
    print(f"mp: {n_procs} processes, {cards} card(s): "
          + ("nccl, a card a process" if cards >= n_procs else
             "gloo on one card exercises the launch path, not NCCL")
          + "; K7's peer form through CUDA IPC")
    (single, _), c = drive(lambda: mp_runs(dev, report=False), launches)
    require(sum(off_masked(c).values()) == 0,
            f"mp single process: no kernel but K10/K11: {c}")
    out_dir = RECORD["mp_dir"]
    if "ell dist strips" in RECORD:     # the whole script's run
        save_reference(out_dir, "ell", RECORD.pop("ell dist strips"))
        open(os.path.join(out_dir, "mesh.flag"), "w").close()
    texts = spawn_workers("--mp-worker", n_procs, out_dir)
    for text in texts:
        print("\n".join(line for line in text.splitlines()
                        if line.startswith(RELAYED)))
    for rank in range(n_procs):
        got = np.load(os.path.join(out_dir, f"rank{rank}.npz"))
        for key, want in single.items():
            rel = float(np.max(np.abs(got[key] - want)
                               / np.maximum(np.abs(want), 1e-300)))
            print(f"mp rank {rank} {key}: max relative difference to "
                  f"one process {rel:.3e}")
            require(np.allclose(got[key], want, rtol=MP_RTOL, atol=0),
                    f"mp rank {rank} {key} within rtol {MP_RTOL:g}")
    with open(os.path.join(out_dir, "rank0.json")) as f:
        rec = json.load(f)
    mesh = rec.pop("mesh", None)
    RECORD.setdefault("k7_peer", {})[n_procs] = rec
    print(f"K7 peer, {n_procs} processes, rank 0: {json.dumps(rec)}")
    if mesh is not None:
        RECORD["k7_mesh"] = mesh
        print(f"K7 mesh, {MESH_PROCS} processes x {MESH_BLOCKS} blocks, "
              f"block 0: {json.dumps(mesh)}")


def peer_entry(rec: dict, n_procs: int) -> dict:
    """The kernels line's entry for K7's peer form (rank 0's numbers)."""
    src, replaces = KERNEL_INFO["rdma_halo_exchange"]
    return {"name": "rdma_halo_exchange_peer", "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "processes": n_procs,
            "device_ms": rec["device_ms"],
            "bound_rate": rec["bound_rate"]}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU "
                           "only")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")

    # phase 1: build the kernels from the sources in the checkout
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    print(_build.build_log())

    # phases 2-3: parity and timing, kernel against plain
    t0 = time.perf_counter()
    errs, times, bounds, by_m = parity_and_timing(dev)
    e123, t123, b123, by_m123 = windowed_parity_and_timing(dev)
    errs.update(e123)
    times.update(t123)
    bounds.update(b123)
    by_m.update(by_m123)
    e56, t56, b56, k5_by_n = rbgs_parity_and_timing(dev)
    errs.update(e56)
    times.update(t56)
    bounds.update(b56)
    errs["rdma_halo_exchange"], t7, b7, k7_lib_ms, k7_device_ms = \
        halo_parity_and_timing(dev)
    times.update(t7)
    bounds.update(b7)
    e8, t8, b8 = split_parity_and_timing(dev)
    errs.update(e8)
    times.update(t8)
    bounds.update(b8)
    e9, t9, b9, by_m9, k9_launches = rm_parity_and_timing(dev)
    errs.update(e9)
    times.update(t9)
    bounds.update(b9)
    by_m.update(by_m9)
    errs[LOOP], times[LOOP], bounds[LOOP] = \
        loop_condition_parity_and_timing(dev)
    e10, t10, b10 = masked_cycle_parity_and_timing(dev)
    errs.update(e10)
    times.update(t10)
    bounds.update(b10)
    e12, t12, b12, k12_by_n = masked_var_sweep_parity_and_timing(dev)
    errs.update(e12)
    times.update(t12)
    bounds.update(b12)
    print(f"phase parity and timing: {time.perf_counter() - t0:.1f} s")

    # phases 4-6: every path through the user entry points, each with the
    # launch counts set to 0 just before it and read just after
    launches = {k: 0 for k in KERNEL_INFO}
    with tempfile.TemporaryDirectory() as mp_dir:
        RECORD["mp_dir"] = mp_dir
        for phase in (const_solves, native_checks, split_solve, pcg_solves,
                      var_solves,
                      refine_solves, smoother_solves, host_solves,
                      graph_solves, ell_solves, dist_solves, dist_var_solves,
                      dist_const_solves, ell_dist_solves, card_solves,
                      dist_graph_solves, ell_graph_solves, mp_solves):
            t0 = time.perf_counter()
            phase(dev, launches)
            torch.cuda.synchronize()
            print(f"phase {phase.__name__}: "
                  f"{time.perf_counter() - t0:.1f} s")
    require(all(n > 0 for k, n in launches.items() if k not in OFF_PATH),
            f"every kernel launched on its path: {launches}")
    for k, why in OFF_PATH.items():
        require(launches[k] == 0, f"{k} on no path ({why})")
    print(f"fused_gs4_sweep_rm launches: {k9_launches} in its parity phase, "
          f"none on a path ({OFF_PATH['fused_gs4_sweep_rm']})")

    errs[PEER], times[PEER], bounds[PEER], peer_cases = \
        RECORD["peer_collective"]
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        kms, pms = times[name]
        bms, by = bounds[name]
        # no single PyTorch call computes a GS sweep, a V-cycle leg, a df32
        # residual or a residual + restriction (K1-K6, K8, K9); K7's
        # strips are one index_select
        lib_ms = k7_lib_ms if name == "rdma_halo_exchange" else None
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": errs[name], "ms": kms, "plain_ms": pms,
                 "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        if name == "rdma_halo_exchange":
            # ms is the per-call time; device_ms the kernel's own
            entry["device_ms"] = k7_device_ms
        if name in by_m:
            entry["ms_by_M"] = {str(M): t for M, (t, _) in by_m[name].items()}
            entry["bound_ms_by_M"] = {str(M): bm
                                      for M, (_, bm) in by_m[name].items()}
        for kname, by_n in (("fused_gs4_sweep_const", k5_by_n),
                            (MASKED_SWEEP, k12_by_n)):
            if name == kname:
                # K5 and K12 work on unpacked (n, n) fields: by side n
                entry["ms_by_n"] = {str(n): t for n, (t, _) in by_n.items()}
                entry["bound_ms_by_n"] = {str(n): bm
                                          for n, (_, bm) in by_n.items()}
        if name == "fused_gs4_sweep_rm":
            # launches stays the path count (0); the parity phase's own
            # launches are reported apart
            entry.update(path=None, parity_launches=k9_launches)
        if name == PEER:
            # ms: the one-row halo gather of the fine level (block 0 of
            # two on the one card); the other payloads by case
            entry["by_case"] = {c: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                                    "bound_ms": r["bound"][0]}
                                for c, r in peer_cases.items()}
        kernels.append(entry)
    kernels.append(peer_entry(RECORD["k7_peer"][MP_PROCS], MP_PROCS))
    kernels.append(cards_entry(RECORD["k7_cards"]))
    kernels.append(mesh_entry(RECORD["k7_mesh"]))
    kernels.append(proc_peer_entry(
        RECORD["k7_peer"][MP_PROCS]["peer_collective"],
        "peer_collective_processes", processes=MP_PROCS, cards=1))
    kernels.append(proc_peer_entry(
        RECORD["k7_mesh"]["peer_collective"], "peer_collective_mesh",
        processes=MESH_PROCS, blocks=MESH_PROCS * MESH_BLOCKS, cards=1))
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def mp_only(procs: list) -> int:
    """``chip_smoke.py --mp P [P ...]``: the process phase alone, once for
    each P (with P cards visible the workers take nccl, a card each)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU "
                           "only")
    print(f"card: {card()}")
    dev = torch.device("cuda")
    launches = {k: 0 for k in KERNEL_INFO}
    with tempfile.TemporaryDirectory() as mp_dir:
        RECORD["mp_dir"] = mp_dir
        references(dev, mp_dir)
        for p in procs:
            mp_solves(dev, launches, p)
    cards = torch.cuda.device_count()
    print(json.dumps({"kernels": [peer_entry(rec, p) for p, rec
                                  in RECORD["k7_peer"].items()]
                      + [proc_peer_entry(
                          rec["peer_collective"], "peer_collective_processes",
                          processes=p, cards=min(p, cards))
                         for p, rec in RECORD["k7_peer"].items()]}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp"] and "--cards" in sys.argv:
        sys.exit(mesh_only(int(sys.argv[2]), int(sys.argv[4])))
    if sys.argv[1:2] == ["--mp"]:
        sys.exit(mp_only([int(a) for a in sys.argv[2:]]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                    sys.argv[5], int(sys.argv[6]))
        sys.exit(0)
    if sys.argv[1:2] == ["--cards"]:
        sys.exit(cards_only(int(sys.argv[2]), "--graph-rows" in sys.argv))
    if sys.argv[1:2] == ["--mp-worker"]:
        mp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
        sys.exit(0)
    sys.exit(main())
