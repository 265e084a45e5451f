"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printed with its wall time, the peak of the device memory
allocated in it and what it leaves allocated (``torch.cuda``'s counts; the
script fails if a phase leaves more than 512 MiB beyond what it held after
the build: a runner kept alive would):

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: ``nvcc`` builds every ``csrc/*.cu`` into one library (one process
   per source, all started together), or finds it built, and prints each
   kernel's registers and spills (``-Xptxas -v``);
3. kernel vs plain, each from the same start state on the card, to
   ``atol=2e-5`` (the kernels do the plain versions' float operations in the
   same order, without FMA contraction: they print max |df| = 0):
   * ``pull_step`` against 20 plain fused steps (``engine.make_fused_step``)
     for SRT, TRT, MRT, MRT+Smagorinsky and SRT+Smagorinsky+Van Driest at
     128^2 and MRT at 1024^2; ``pull_step_tangential`` (the entry
     ``lbm_pull_step_tangential``, the tangential lid) against 20 plain
     steps of the tangential engine for the same cases;
   * ``tblock_step`` (K=8, 20 steps: two launches and four one-step
     remainder launches) against 20 plain fused steps for SRT, TRT, MRT and
     MRT+Smagorinsky at 128^2 and MRT at 2048^2, and (default K) against
     ``pull_step`` over 64 steps at 2048^2, 4096^2 and the Re=100 Ghia
     run's 128^2, which must agree exactly;
   * ``push_step`` against 20 push-oracle steps
     (``engine.make_push_oracle_step``) for the same four cases at 128^2 and
     MRT at 1024^2, and its entry ``lbm_push_step_wall`` for the two walls
     only the push engines implement, ``push_step_west_eq``
     (``nebb_west_eq``) and ``push_step_bounce_back`` (``bounce_back``),
     for the same four cases at 128^2, at the main path's 48^2 and MRT at
     1024^2; bit for bit (atol 0);
   * on a 2x2 mesh of this one card (``devices=[card] * 4``, each shard with
     its real wall flags and halo strips): ``pull_sharded_step`` (SRT, TRT,
     MRT, MRT+Smagorinsky, SRT+Smagorinsky+Van Driest) and
     ``tblock_sharded_step`` (K=5, the first four) against 20 steps of the
     plain sharded engine at 256^2, and both at the sizes the main path
     runs them (MRT 4096^2 and the Re=100 Ghia case at 128^2, each on the
     2x2 mesh); ``cuda-sharded`` against ``cuda-pull`` over 64 steps at
     4096^2 on 2x2 and 1x4 meshes, which must agree exactly;
     ``tblock_sharded_step`` against ``pull_sharded_step`` over 64 steps at
     4096^2 on 2x2 and 4x1 meshes, which must agree exactly;
   * (a) ``halo_exchange``'s whole refresh (``make_halo_exchange``: y and
     x strips, corners from the diagonal shard, and with panels their x
     halos and their copy from ``iy = 0``) on carry sets filled from a
     seeded generator, at the shapes the main paths give it (tight K=5 with
     panels at 4096^2 on 2x2 and 4x1 meshes of the card and at 128^2 on
     2x2; aligned depth 1 without panels at 4096^2 and 128^2 on 2x2),
     against its definition, ``halo.refresh_phases`` copied in order, on a
     copy: equal byte for byte, one launch; its x-only table
     (``make_x_halo_exchange``) against the x-phase copies; (b) the
     temporal-block sharded runner with ``halo_impl="rdma"`` against
     ``"ppermute"`` at 4096^2 MRT Re=5000 on the same meshes and at 128^2,
     over 64 and 67 steps (the latter through the remainder), and the
     one-step runner against the same launches driven by the two-phase
     copies at 4096^2 and 128^2 over 67 steps: max |d| = 0, one exchange
     launch per block (per step) and no halo copy in the loop;
4. main paths, each launch counter set to 0 just before a run and read just
   after it:
   * ``simulate`` and ``run_to_convergence`` at 1024^2 MRT float32 (the
     benchmark's cavity) and the two default-suite Ghia gates (MRT 96^2,
     Re=100 and Re=400) through ``cuda-pull``;
   * the tangential lid through ``auto`` (routed to ``cuda-pull``, the
     tangential entry's launches counted): the slow gate
     ``re100_128_nebb_tangential`` (128^2 SRT Re=100, 40 000 steps; R2(Ux)
     > 0.99, L2 < 0.05) and the BC-closure control ``re1000_512_tang``
     (512^2 MRT Re=1000, 600 000 steps in 100 000-step intervals; R2(Ux) >=
     0.9993, L2 <= 0.021), with its wall time and MLUPS;
   * ``simulate`` at 2048^2 MRT float32 Re=5000 with ``backend="auto"`` (the
     large-cavity path), and through an explicit ``cuda-tblock`` when auto
     picks another backend; the Re=100 Ghia gate at 128^2 through
     ``cuda-tblock``;
   * the Re=100 Ghia gate at 96^2 through ``cuda-push``;
   * 48^2 ``bounce_back`` and ``nebb_west_eq`` runs through ``auto``, which
     routes them to ``cuda-push`` (the push kernel's wall entry);
   * the sharded cavity: ``simulate`` at 4096^2 MRT float32 Re=5000 on a
     2x2 mesh of this card with ``backend="auto"`` and through the sharded
     kernel that auto does not take there (``cuda-sharded`` or
     ``cuda-sharded-tblock``), in the order auto, other, other, auto;
   * the Re=100 Ghia gate at 128^2 on the 2x2 mesh through both sharded
     routes (``cuda-sharded-tblock`` refreshes through the exchange kernel,
     ``sim.SHARDED_TBLOCK_HALO_IMPL``), with their MLUPS; every sharded
     run's exchange launches and halo copies checked (one launch per step
     or block, copies only once per call);
   * the ``"rdma"`` runner driven directly at 4096^2 on the 2x2 mesh in
     500-step calls, with its launches and copies;
   * (c) the remote form: two processes on the card (a ``gloo`` group on a
     ``file://`` store), after a probe that CUDA IPC maps memory between
     them; on a (2, 1) mesh at 1024^2 MRT, the ``"rdma"`` runner (x strips
     written through IPC into the other process's carries) and the
     ``"ppermute"`` runner (x strips sent through host-staged ``gloo``),
     gathered on rank 0, against the one-process mesh over 64 steps: max
     |d| = 0; and the two-process exchange's time with its host barriers;
5. timing with CUDA events: the measured device-copy bandwidth; the
   benchmark's 1024^2 MRT cavity through ``bench.measure`` (the bench's
   own measurement, routed to ``pull_step``, its launches counted; MLUPS
   by CUDA events and on the wall clock, and ``bench.py``'s JSON line);
   ``pull_step_tangential`` and ``pull_step`` in turns at 1024^2 MRT, and
   the plain tangential engine; at 1024^2
   and 2048^2, ``pull_step`` beside ``tblock_step`` for K in ``SWEEP_K``;
   at 1024^2, 2048^2 and 4096^2, ``pull_step`` and ``tblock_step`` (default
   K) in turns from rest and from the state after 1 920 steps, which sets
   where ``auto`` takes the latter;
   ``push_step`` at 1024^2, and each of its other two walls in turns with
   it (nebb, wall, wall, nebb); each kernel's plain version; at 4096^2 on the
   2x2 mesh: both sharded runners from rest in ``simulate``'s calls, with
   the one-step runner's pad and unpad copies timed apart; from a state
   further on,
   ``pull_sharded_step`` and ``tblock_sharded_step`` (default K) with the
   halo exchange timed apart, and the two sharded runners in turns, which
   with the main path's MLUPS sets where ``auto`` takes the temporal-block
   one; (d) at 4096^2 on the 2x2 mesh, the whole refresh in one launch
   and its x-only table, against the refresh's phases and the same moves by
   ``copy_pairs``, each as device ms with the queue held busy (a sleep
   kernel ahead of the event pair, so the calls queue and the events see
   the device) and host us per call, beside the bound; both sharded
   runners against their copy-driven forms in turns from the state 7 680
   steps on; 6. at 96^2 and 128^2, the per-step device time (queue held
   busy), host time, end-to-end time and idle share of ``cuda-pull`` and
   ``cuda-tblock``, and on the 2x2 mesh of both sharded runners beside
   their copy-driven forms, in turns.
The sweep form of ``pull_step`` (``lbm_pull_sweep_step``: cavities stacked
along x, each with its own omega) and the surrogate pipeline:

(g) at the datagen CLI's cavity (384^2, SRT + Smagorinsky, float32) with 32
    stacked cavities: the kernel against the plain stacked step
    (``engine.make_stacked_step_omega``) over 20 steps from rest and from a
    noisy state (atol 2e-5); the stack against cavities 0, 15 and 31 run
    alone through the one-cavity form over 200 steps (max |d| = 0); a
    cavity seeded with NaN, every other cavity finite and equal to its run
    alone; TRT and MRT at 128^2 with 4 cavities against the plain step;
    timing in turns against ``pull_step`` at 1024^2, per cell (ms/step,
    MLUPS, the fraction of the 72 B/cell bound), and the one-cavity runner's
    device time per step at 384^2 with the queue held busy;
(h) ``ml.generate_dataset`` at 384^2 over 32 Re (100..410) through the
    stacked kernel, 4 000 steps in 2 000-step chunks, its launches counted
    (set to 0 just before, read just after), its steps, wall time and
    MLUPS; the four arrays' shapes and finiteness; ``save_dataset`` /
    ``load_dataset`` round trip; a batch of 4 through the plain engine on
    the card against the kernel's route after 20 steps (atol 2e-5);
(i) serving: ``cnn_eight`` at 384^2 with seeded random weights,
    ``build_input`` on (h)'s ``feq_initial`` with ``prepare_inputs``'
    scalers, ``predict_velocity`` on the card against the CPU (rtol 1e-4,
    atol 1e-5, TF32 off), and a batch-20 forward pass timed with TF32 off
    and on;
(i') the repo's trained ``cnn_nine`` read by ``load_weights`` from its
    tracked ``.msgpack`` files (``docs/artifacts/ml_full/cnn_nine``, read
    without flax) onto the card, served at 384^2 on ``build_input`` of
    (h)'s ``feq_initial`` with the files' scalers, against the CPU forward
    (rtol 1e-4, atol 1e-5, TF32 off); a JAX training checkpoint
    (``ml_full/cnn_eight_faithful/cnn_eight_x.ckpt``) carried onto the card
    by ``train._load_train_checkpoint`` under its own recipe, its tensors
    counted;
(j) training ``cnn_eight`` at 384^2 with its batch of 20 on (h)'s 32
    cavities (26 training, 6 validation): components x and y for 3 epochs
    (finite losses); the first minibatch's gradients on the card against
    the CPU's from the same weights with TF32 off (the weights of the
    layers after the last ReLU masks, per tensor ||dg|| <= 2e-5 ||g||), and
    the same backward in TF32 missing that tolerance; one step from the
    same weights against the CPU (loss rel 1e-5, per tensor ||dp|| <= 1e-2
    of the update); a run resumed after 2 of 3 epochs against the
    uninterrupted one under ``cudnn.deterministic`` (bit for bit); the
    (2, 1) mesh of the card against one device (loss rel 1e-4, parameters
    rtol 2e-4, atol 1e-6); ``save_weights`` / ``load_weights`` through
    ``predict_velocity`` (equal); a training step timed with CUDA events,
    TF32 off and on in turns, and an epoch with its validation pass; no
    kernel of the port launched;
(k) ``generate_dataset`` over 8 Re in one batch on a (2, 1) mesh of the
    card, 20 steps: equal to one stack bit for bit, 2 sweep launches per
    step (counted);
(l) ``simulate`` at 256^2 MRT with checkpoints every 1 000 of 3 000 steps,
    then resumed from step 2 000, on ``cuda-pull`` and on ``cuda-sharded``
    (2x2 mesh of the card): the final checkpoints equal bit for bit, the
    resumed run's launches counted and its MLUPS over the steps it ran;
(m) the command line, each command a subprocess
    (``python -m latticeboltzmannsimulations_torch``): ``run`` of the
    benchmark's cavity (1024^2 MRT Re=5000, 6 000 steps in 2 000-step
    intervals, ``--vtk``, a checkpoint every interval, the first chunk
    profiled): routed to ``cuda-pull``, its three ``.vtr`` files equal byte
    for byte to an in-process ``simulate`` with the same options and no
    profile, its ``trace.json`` holding exactly 2 000 ``pull_step`` kernel
    events, replayed from the chunk's graph (their device time per step,
    the chunk's idle share, the host's us between launches while it
    captures, and the graph launches printed beside the MLUPS); in-process
    ``simulate`` in turns without outputs, with ``--vtk``'s outputs, with
    the command's outputs and with its profile too, their launches counted,
    for the cost of each; the same profiled run at 128^2 Re=100, and that
    size with and without the profile in turns; ``datagen`` of (h)'s 32
    cavities, its ``.npy`` files equal to (h)'s arrays bit for bit; and a
    line naming what it does not drive on the card (``--plots``, ``train``
    and ``predict`` draw with matplotlib, where the machine has none).

(n) the CUDA-graph runners (``kernels/graphs.py``: a chunk's launches
    captured at a runner's first call, replayed once per call): each
    against its eager form, the same launches issued one by one from the
    host (the modules' ``_eager_*`` runners), on the same seeded state:
    ``pull`` (MRT, SRT + Smagorinsky + Van Driest, the tangential lid) at
    128^2 over 1, 2, 7, 2 000 and 4 001 steps (the 2 000-launch body
    replayed twice and an odd remainder), the sweep at 32 x 384^2 over 200
    steps with its omegas changed between calls, ``tblock`` over 2 003
    steps at 128^2 and 67 at 2048^2, ``push`` (each of its three walls)
    over 7 and 2 001 at 128^2 and 67 at 1024^2, and both sharded runners (the temporal-block one under
    both transports) on the 2x2 mesh of the card over 2 003 steps at 128^2
    and 67 at 4096^2: max |d| = 0, the input untouched, the state a call
    returned unchanged by the next, every launch counter (and
    ``halo.copies``, but for the lid densities a graphed sharded runner
    copies out of the rows it keeps) at the eager count; the capture's
    wall time per runner; every main path's graph launches checked against
    its chunks' plans;
(o) timing, graph against eager form in turns (graph, eager, eager,
    graph), ms per step end to end on an idle queue: ``cuda-pull`` and
    ``cuda-tblock`` in 2 000-step calls at 96^2, 128^2, 256^2, 1024^2 and
    2048^2; both sharded runners on the 2x2 mesh at 128^2 (2 000-step
    calls) and 4096^2 (480); a 2 000-step ``cuda-pull`` chunk at 128^2 and
    1024^2 captured as bodies of 250 to 2 000 launches (the capture's cost
    against the graph launches a chunk takes); ``simulate``'s MLUPS of the
    Re=100 128^2 gate
    (``re100_128_nebb_tangential``) and of the 1024^2 Re=5000 main path,
    the eager forms swapped in for the runner factories;
(p) the bench command, after the timing: ``python -m
    latticeboltzmannsimulations_torch bench`` as a subprocess, exactly one
    stdout line with ``bench.py``'s four keys, the 1024^2 MRT cavity on
    ``cuda-pull`` and a positive value, printed beside the timing phase's
    ``pull_step`` MLUPS;
(q) the slow gates, after the tangential lid's main path: the four gates of
    ``scripts/torch_slow_gates.py`` in process through ``auto``
    (``re400_256_mrt`` must converge within 1.2 M steps,
    ``re1000_256_mrt``, ``re100_128_bounce_back`` on the push kernel,
    ``re100_128_nebb_tangential``), each with its route and wall time, its
    launches counted (one per step on the routed kernel) and its own
    bounds, beside the
    JAX package's record; a failed gate fails the script;
(r) the surrogate pipeline's scripts in process
    (``scripts/torch_datagen_full.py``, ``torch_datagen_topup.py``,
    ``torch_check_dataset.py``, ``torch_predict_extrapolate.py``): the
    310..370 chunk of JAX's dataset record at 96^2 (7 cavities, checks every
    500 steps), a 1 000-step sweep and a 1 000-step top-up, each against the
    same pass through the plain stacked step on the card (chunk files equal,
    max |d| = 0); the same chunk at 384^2 with the scripts' defaults, a
    20 000-step sweep and a 20 000-step top-up through the kernel, its
    launches counted, the chunk's keys, shapes and cumulative steps, a
    re-run that skips the done Re values and launches nothing, and the
    dataset check's fixed fields against JAX's record; ``cnn_eight``,
    ``cnn_nine`` and ``cnn_ten`` at Re = 7500 from the tracked weights on
    that dataset's template, served at the TPU's precision (bfloat16
    operands) within 1e-3 of JAX's ``cnn_vs_lbm_l2`` against its tracked
    truth, their float32 numbers printed beside JAX's record, and their
    float32 serving on the card held to the CPU forward (rtol 1e-4, atol
    1e-5, TF32 off);
(s) ``scripts/torch_train_full.py`` and ``scripts/torch_pipeline_cards.py``
    (``run_train_scripts``): the pipeline runner as a subprocess over two
    ranges of the one card (four chunks of JAX's record at 96^2, 1 000-step
    sweep and top-up), merged and assembled, against the same passes in one
    directory in process, bit for bit; while it runs, on a dataset made in
    the call (ten cavities at 96^2 through the sweep kernel, train_full's
    held-out Re 500 among them), ``cnn_one``'s first minibatch gradients
    card against CPU, then ``torch_train_full.main`` in process on the card
    (``cnn_one`` at 96^2, x and y, and the early preset at 48^2, two epochs
    each) and on the CPU from the same weights (``cnn_one`` alone), its
    numbers within 1e-3; the card run's kept held-out truth
    (``held_out_truth.npz``, whose ``feq_initial`` the configuration
    rebuilds, so it is not stored) re-read and the saved halves scored on
    it on the card (``torch_train_full.score_saved``), equal to the in-run
    evaluation within 1e-5 (the records' fifth decimal);
(t) the pipeline runner's epoch estimates (``time_training_epochs``): a
    training step and a validation forward of each of its jobs' models at
    the job's grid and batch, timed (the fastest of seven blocks), and the epoch they make on 493
    cavities printed beside ``torch_pipeline_cards.EPOCH_S``, which must lie
    within a factor of 2;
(u) the whole-dataset scripts and the sweep's determinism
    (``check_sweep_determinism``, ``run_whole_dataset_scripts``);
(v) the last three scripts at a cut scale (``run_last_scripts``):
    ``scripts/torch_probe_fidelity.py``'s run ``re400_192_srt`` cut to 96^2
    and two 2 000-step intervals through ``auto`` (``cuda-pull``, launches
    counted), equal bit for bit to ``simulate(backend="cuda-pull")`` of the
    same configuration (steps, R2(Ux), L2 and every interval's log row);
    ``scripts/torch_rollup_validation.py`` over that run's log (its row the
    probe's, rounded as JAX rounds, with route and card); and
    ``scripts/torch_weak_scaling_cpu.py``'s measurement on 1x1 and 2x2 meshes
    of 64^2 shards on the card, routed to ``cuda-sharded`` against
    ``cuda-pull``, over 3 000 timed steps, launches counted (one exchange a
    step on 1x1 too), each mesh's final state equal to ``cuda-pull``'s.

The last three lines are ``nvidia-smi``'s line, one JSON object describing
each kernel, and ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result; so does a machine with no
CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import math
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import torch.distributed as dist
from torch.multiprocessing.reductions import rebuild_cuda_tensor, reduce_tensor

import latticeboltzmannsimulations_torch as lbt
from latticeboltzmannsimulations_torch import bench, engine, ml, sim
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import (
    _build,
    graphs,
    halo_rdma,
    pull,
    pull_sharded,
    push,
    tblock,
    tblock_sharded,
)
from latticeboltzmannsimulations_torch.parallel import (
    halo,
    make_mesh,
    make_sharded_fused_step,
    make_sharded_scan_runner,
    multihost,
    shard_state,
    unshard_state,
)
from latticeboltzmannsimulations_torch.ml import datagen, models, predict, train
from latticeboltzmannsimulations_torch.sim import SimOptions, simulate
from latticeboltzmannsimulations_torch.validate import compare_to_ghia

ATOL = 2e-5
# The temporal-block kernels do the one-step kernels' arithmetic in the same
# order: they must agree exactly.
TBLOCK_VS_PULL_ATOL = 0.0
# The TPU kernel each CUDA kernel replaces, in the JAX package.
REPLACES = {
    "pull_step": "kernels/pallas_pull.py:189 (_make_kernel)",
    "tblock_step": "kernels/pallas_pull_tblock.py:72 (_make_kernel)",
    "push_step": "kernels/pallas_push.py:65 (_make_kernel)",
    # no Pallas kernel: the JAX package runs these walls on its push oracle
    # (the Pallas push kernel refuses them, kernels/pallas_push.py:178-181)
    "push_step_west_eq": ("sim.py:64-90 (_push_style: boundary='nebb_west_eq' on the "
                          "push oracle; kernels/pallas_push.py:65 refuses it)"),
    "push_step_bounce_back": ("sim.py:64-90 (_push_style: boundary='bounce_back' on the "
                              "push oracle; kernels/pallas_push.py:65 refuses it)"),
    "pull_sharded_step": "kernels/pallas_pull_sharded.py:84 (_make_local_kernel)",
    "tblock_sharded_step": "kernels/pallas_pull_tblock_sharded.py:57 (_make_kernel)",
    "halo_exchange": ("kernels/halo_rdma.py:137 (make_x_halo_exchange; "
                      "_make_local_kernel :57, _make_remote_kernel :85)"),
    "pull_sweep_step": ("kernels/pallas_pull.py:470 (the pallas_call's sweep form: "
                        "make_sweep_runner :560, make_scan_runner_omega :543)"),
    # no Pallas kernel: the JAX driver runs this wall on its XLA-fused engine
    "pull_step_tangential": ("sim.py:107-113 (the tangential lid's XLA-fused "
                             "engine.make_scan_runner)"),
}
SOURCES = {name: f"latticeboltzmannsimulations_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["pull_sweep_step"] = SOURCES["pull_step"]     # a second entry of that source
SOURCES["pull_step_tangential"] = SOURCES["pull_step"]  # and a third
# the entry lbm_push_step_wall of push_step.cu, for the two walls
SOURCES["push_step_west_eq"] = SOURCES["push_step_bounce_back"] = SOURCES["push_step"]
# Each kernel's launch counter: (module, attribute).
COUNTERS = {"pull_step": (pull, "launches"), "tblock_step": (tblock, "launches"),
            "push_step": (push, "launches"),
            "push_step_west_eq": (push, "west_eq_launches"),
            "push_step_bounce_back": (push, "bounce_back_launches"),
            "pull_sharded_step": (pull_sharded, "launches"),
            "tblock_sharded_step": (tblock_sharded, "launches"),
            "halo_exchange": (halo_rdma, "launches"),
            "pull_sweep_step": (pull, "sweep_launches"),
            "pull_step_tangential": (pull, "tangential_launches")}
COMPARE_STEPS = 20
TBLOCK_COMPARE_K = 8
BENCH_N = 1024
LARGE_N = 2048
BENCH_CHUNK = 10_000
BENCH_CHUNKS = 3
SWEEP_STEPS = 1_920                # a multiple of every K of the sweep
SWEEP_K = (4, 5, 6, 8, 10, 12, 16)
AHEAD_N = (1024, 2048, 4096)       # sizes where tblock_step meets pull_step
# tblock_step counts as ahead only by more than the 1.5% spread of MLUPS
# between calls (PERF.md): a smaller lead changed sign from call to call.
AHEAD_MARGIN = 1.015
BYTES_PER_CELL = 72               # one read and one write of 9 f32 planes
# Floating-point operations per cell of the kernels' MRT path (no LES),
# counted from csrc/lbm_cell.cuh: one per add, multiply or divide.
FLOPS_PER_CELL_MRT = 170
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# The sharded cavity: the BASELINE's scale-out size, on a 2x2 mesh of this
# one card (and a 1x4 mesh for the comparison with pull_step).
SHARDED_N = 4096
SHARDED_MESH = (2, 2)
SHARDED_COMPARE_N = 256
SHARDED_STEPS = SWEEP_STEPS        # a multiple of the sharded tblock's K
SHARDED_WARM_STEPS = 4 * SHARDED_STEPS   # steps before the sharded timing
# The halo exchange kernel: the meshes of the card it is checked on, the
# steps of the runner comparison (the second runs through the remainder),
# the two-process case, and the launches per timing.
RDMA_MESHES = (SHARDED_MESH, (4, 1))
RDMA_COMPARE_STEPS = (64, 67)
IPC_N = 1024
IPC_MESH = (2, 1)
IPC_STEPS = 64
EXCHANGE_REPS = 200
IPC_EXCHANGE_REPS = 50
# Small grids (host-bound): the sizes whose per-step device time is taken
# with the queue held busy, and the steps per timed call (few enough
# launches to queue behind the sleep: the launch queue holds about 1 000).
SMALL_N = (96, 128)
SMALL_STEPS = 100
SMALL_SHARDED_STEPS = 10
SMALL_CALL_STEPS = 2_000           # the Ghia runs' report interval
# Steps per call of the sharded runners timed in turns at 4096^2.
RUNNER_TURN_STEPS = 480
# The sweep form: the datagen CLI's cavity (384^2, SRT + Smagorinsky, float32)
# with generate_dataset's default batch of 32 stacked cavities; the cavities
# run alone against the stack, the NaN cavity, and the small TRT/MRT case.
SWEEP_N = 384
SWEEP_CAV = 32
SWEEP_SINGLES = (0, 15, 31)
SWEEP_SINGLE_STEPS = 200
SWEEP_NAN_CAVITY = 7
SWEEP_NAN_STEPS = 50
SWEEP_SMALL_N, SWEEP_SMALL_CAV = 128, 4
# generate_dataset on the card: 32 Re from 100, two chunks of the CLI's
# interval; the plain engine's batch and steps beside the kernel's route.
DATAGEN_RE = np.arange(100.0, 420.0, 10.0)
DATAGEN_MAX_STEPS = 4_000
DATAGEN_INTERVAL = 2_000
DATAGEN_PLAIN_BATCH = 4
# Serving: the preset at its native grid, the Re of the input, and the
# forward passes per timing.
SERVE_PRESET = "cnn_eight"
SERVE_RE = 255.0
SERVE_REPS = 10
# Training (j): the same preset at 384^2 with its batch of 20, on (h)'s 32
# cavities (26 training, 6 validation: one step per epoch), with the
# tolerances of its card-against-CPU checks.  Gradients: per tensor
# ||g_card - g_cpu|| <= GRAD_RTOL ||g_cpu|| for the weights of the layers
# after the last ReLU masks but head0's (TAIL_LAYERS), pure float32
# rounding there (1e-6 to 4e-6 on an H100); a bias's gradient is a sum
# over every pixel of the batch, which no TF32 product enters and whose
# float32 rounding reaches 6e-5; deeper, a unit whose pre-activation lies within
# rounding of zero passes or blocks its whole upstream gradient on one side
# only, which float32 on the CPU shows against float64 too (up to 4e-4 of
# a tensor; the check prints both against the CPU's float64 gradients), so
# those layers are printed, not held.  A TF32 backward (10-bit
# inputs) leaves 1e-4 to 3e-4 in every tail layer.  After one step from the
# same weights: per tensor ||p_card - p_cpu|| <= STEP_RTOL ||p_cpu - p0||
# (RMSprop's update keeps a gradient's relative error or saturates), the
# loss to rel 1e-5.
TAIL_LAYERS = ("head0", "dec_a_deconv4", "dec_b_deconv4")
GRAD_RTOL = 2e-5
STEP_RTOL = 1e-2
TRAIN_EPOCHS = 3
TRAIN_REPS = 10
# generate_dataset on a mesh (k): 8 Re in one batch over a (2, 1) mesh of the
# card, 20 steps.
MESH_RE = np.arange(100.0, 500.0, 50.0)
MESH_STEPS = 20
# Checkpoint and resume (l): 256^2 MRT, checkpoints every 1 000 of 3 000
# steps, the run resumed from the middle one.
CKPT_N = 256
CKPT_STEPS = 3_000
CKPT_INTERVAL = 500
CKPT_EVERY = 1_000
# The command line (m): the benchmark's cavity through `run`, three intervals,
# the first profiled; the Re=100 cavity at 128^2 profiled the same way; each
# command's time limit.
REPO = os.path.dirname(os.path.abspath(__file__))
CLI_STEPS = 6_000
CLI_INTERVAL = 2_000
CLI_SMALL_N = 128
CLI_TIMEOUT_S = 300
# The tangential lid: the slow gate re100_128_nebb_tangential
# (scripts/slow_gates.py) and the BC-closure control re1000_512_tang
# (scripts/r5_validate.py) at full size, cut to 600 000 steps, where the JAX
# run's metrics read R2(Ux) 0.999384, L2 0.019967 and hold to 4 M steps
# (docs/artifacts/re1000_512_tang).
TANG_GATE_STEPS = 40_000
TANG_CONTROL_N = 512
TANG_CONTROL_STEPS = 600_000
TANG_CONTROL_INTERVAL = 100_000
# The repo's trained surrogate served from its flax files, and the JAX
# training checkpoint decoded.
ARTIFACT_WEIGHTS = os.path.join(REPO, "docs", "artifacts", "ml_full", "cnn_nine")
ARTIFACT_PRESET = "cnn_nine"
ARTIFACT_CKPT = os.path.join(REPO, "docs", "artifacts", "ml_full", "cnn_eight_faithful",
                             "cnn_eight_x.ckpt")
# CUDA graphs (kernels/graphs.py): the steps each graphed runner is held to
# its eager form at (4 001: the body of 2 000 launches replayed twice and an
# odd remainder), the sizes and steps per call of the timings in turns, and
# the device memory a phase may leave held beyond what the script held after
# the build (a runner kept alive at 4096^2 holds more than a GiB).
GRAPH_STEPS = (1, 2, 7, graphs.MAX_BODY, 2 * graphs.MAX_BODY + 1)
GRAPH_SWEEP_STEPS = 200
GRAPH_TBLOCK_STEPS = {128: 2_003, LARGE_N: 67}
GRAPH_PUSH_STEPS = {128: (7, 2_001), BENCH_N: (67,)}
GRAPH_SHARDED_STEPS = {128: 2_003, SHARDED_N: 67}
GRAPH_TIMING_N = (96, 128, 256, BENCH_N, LARGE_N)
GRAPH_SHARDED_CALL_STEPS = {128: SMALL_CALL_STEPS, SHARDED_N: RUNNER_TURN_STEPS}
# the bodies (launches per graph) whose capture a 2 000-step chunk is timed
# with: the cost of capturing against the graph launches per chunk
GRAPH_BODIES = (250, 500, 1_000, 2_000)
HELD_MARGIN = 512 * 2**20
PULL_KERNEL = "pull_step_kernel"     # pull_step's __global__ in csrc/pull_step.cu
#                                      (in an anonymous namespace there)
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


# (phase, peak device bytes allocated in it, bytes still allocated at its end)
MEMORY = []


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    gc.collect()
    peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    MEMORY.append((name, peak, held))
    print(f"== {name}: {time.perf_counter() - t0:.2f} s; device memory peak "
          f"{peak / 2**30:.3f} GiB, held at the end {held / 2**30:.3f} GiB", flush=True)


def check_memory() -> None:
    """No phase leaves more device memory allocated than the script held
    after the build plus ``HELD_MARGIN``: a runner that outlived its phase
    (its buffers and graphs) would."""
    base = dict((name, held) for name, _, held in MEMORY)["build"]
    print("  device memory by phase, GiB (peak, held at the end): " + "; ".join(
        f"{name} {peak / 2**30:.3f} {held / 2**30:.3f}" for name, peak, held in MEMORY),
        flush=True)
    grown = [(name, held) for name, _, held in MEMORY if held > base + HELD_MARGIN]
    if grown:
        raise AssertionError(f"phases left device memory held beyond {base} + "
                             f"{HELD_MARGIN} bytes: {grown}")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` over ``reps`` calls, by CUDA events recorded
    on an idle queue: for small launches the host's pace, not the
    device's (``busy_time``)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles per ms of device time on this card,
    measured once."""
    torch.cuda._sleep(1_000_000)
    return 10_000_000 / cuda_time_ms(lambda: torch.cuda._sleep(10_000_000), 3)


def busy_time(fn, reps: int) -> tuple[float, float]:
    """(device ms, host us) per call of ``fn()``: the host's time to issue
    ``reps`` calls, and the device's time to run them with the queue held
    busy ahead of the event pair (a sleep kernel longer than the issuing),
    so the calls queue up and the events see the device, not the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = 2e3 * host_s + 5.0
    for _ in range(3):
        torch.cuda._sleep(int(sleep_cycles_per_ms() * sleep_ms))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        issued_s = time.perf_counter() - t0
        # the device still sleeping when the last call is issued: every call
        # queued before the first ran
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps, host_s * 1e6 / reps
        sleep_ms = 4e3 * issued_s + 10.0
    raise AssertionError(f"the device began the calls before the host had issued them "
                         f"all ({issued_s * 1e3:.2f} ms, after a {sleep_ms:.1f} ms sleep): "
                         "the calls wait for the device, or fill its queue")


nvidia_smi_line = bench.card_line


def check_close(name: str, cfg: SimConfig, f_a, f_b, lid_a=None, lid_b=None,
                atol: float = ATOL) -> float:
    """Print and check max |df| (and max |d rho_lid| where given)."""
    torch.cuda.synchronize()
    err_f = (f_a - f_b).abs().max().item()
    err_lid = 0.0 if lid_a is None else (lid_a - lid_b).abs().max().item()
    lid_txt = "" if lid_a is None else f" max|d rho_lid|={err_lid:.3e}"
    print(f"  {name:36s} {cfg.nx}x{cfg.ny}: max|df|={err_f:.3e}{lid_txt} "
          f"(atol {atol:g})", flush=True)
    if not (math.isfinite(err_f) and math.isfinite(err_lid)):
        raise AssertionError(f"{name}: non-finite difference")
    if err_f > atol or err_lid > atol:
        raise AssertionError(f"{name}: the two differ beyond {atol}")
    return max(err_f, err_lid)


def compare_case(name: str, cfg: SimConfig, device) -> float:
    """20 one-step kernel steps against 20 plain steps."""
    plain = engine.make_fused_step(cfg)
    kernel = pull.make_step(cfg, device)
    s_plain = s_kernel = engine.init_state(cfg, device)
    for _ in range(COMPARE_STEPS):
        s_plain = plain(s_plain)
        s_kernel = kernel(s_kernel)
    return check_close(f"pull {name}", cfg, s_kernel.f, s_plain.f,
                       s_kernel.rho_lid, s_plain.rho_lid)


def compare_tblock(name: str, cfg: SimConfig, device) -> float:
    """20 steps through the temporal-block runner (K=8: two launches, then
    four one-step remainder launches) against 20 plain steps."""
    plain = engine.make_fused_step(cfg)
    s0 = engine.init_state(cfg, device)
    s_plain = s0
    for _ in range(COMPARE_STEPS):
        s_plain = plain(s_plain)
    before = tblock.launches
    s_kernel = tblock.make_scan_runner(cfg, COMPARE_STEPS, device,
                                       k_steps=TBLOCK_COMPARE_K)(s0)
    if tblock.launches - before != COMPARE_STEPS // TBLOCK_COMPARE_K:
        raise AssertionError("the tblock runner did not launch K-step blocks")
    return check_close(f"tblock K={TBLOCK_COMPARE_K} {name}", cfg, s_kernel.f,
                       s_plain.f, s_kernel.rho_lid, s_plain.rho_lid)


def compare_tblock_pull(cfg: SimConfig, device, n: int) -> float:
    """The temporal-block kernel (default K) against the one-step
    kernel over n steps (the remainder through the latter): the same
    arithmetic in the same order, so they must agree exactly."""
    s0 = engine.init_state(cfg, device)
    a = tblock.make_scan_runner(cfg, n, device)(s0)
    b = pull.make_scan_runner(cfg, n, device)(s0)
    return check_close(f"tblock K={tblock.K_STEPS} vs pull_step, {n} steps", cfg,
                       a.f, b.f, a.rho_lid, b.rho_lid, atol=TBLOCK_VS_PULL_ATOL)


# The push kernel's walls: its counter's name in COUNTERS by boundary.
PUSH_KERNELS = {"nebb": "push_step", "nebb_west_eq": "push_step_west_eq",
                "bounce_back": "push_step_bounce_back"}


def compare_push(name: str, cfg: SimConfig, device) -> float:
    """20 push-kernel steps against 20 push-oracle steps, bit for bit: the
    kernel does the oracle's operations in its order (PERF.md, section 6)."""
    plain = engine.make_push_oracle_step(cfg)
    kernel = push.make_push_step(cfg, device)
    f_plain = f_kernel = engine.init_state(cfg, device).f
    for _ in range(COMPARE_STEPS):
        f_plain = plain(f_plain)
        f_kernel = kernel(f_kernel)
    return check_close(f"push {cfg.boundary} {name}", cfg, f_kernel, f_plain, atol=0.0)


def check_runner_ping_pong(device) -> None:
    """The scan runner's two buffers give the same trajectory as stepping
    (an odd count ends on the second buffer), and leave the input alone;
    with Van Driest damping too (the runner keeps its Cs^2 plane alive)."""
    for name, kw in (("mrt", dict(reynolds=400.0, collision="mrt")),
                     ("srt+smagorinsky+van_driest", dict(
                         reynolds=5000.0, collision="srt", turbulence="smagorinsky",
                         van_driest=True))):
        cfg = SimConfig(nx=128, ny=128, **kw)
        s0 = engine.init_state(cfg, device)
        f0 = s0.f.clone()
        out = pull.make_scan_runner(cfg, 7, device)(s0)
        step = pull.make_step(cfg, device)
        s = s0
        for _ in range(7):
            s = step(s)
        torch.cuda.synchronize()
        if not (torch.equal(out.f, s.f) and torch.equal(out.rho_lid, s.rho_lid)):
            raise AssertionError(f"{name}: scan runner and stepwise kernel differ")
        if not torch.equal(s0.f, f0):
            raise AssertionError(f"{name}: the scan runner wrote its input state")
        print(f"  {name}: scan runner (7 steps) == 7 single steps, input untouched",
              flush=True)


def sharded_mesh(device, shape=SHARDED_MESH):
    """A mesh of ``shape`` shards, every one on this card."""
    return make_mesh(shape, [device] * (shape[0] * shape[1]))


def compare_sharded(name: str, cfg: SimConfig, device, module) -> float:
    """20 steps of a sharded kernel's runner (``module``: ``pull_sharded`` or
    ``tblock_sharded`` at its default K) against 20 steps of the plain
    sharded engine, on a mesh of this card."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = shard_state(engine.init_state(cfg, device), mesh)
    plain = unshard_state(make_sharded_scan_runner(cfg, COMPARE_STEPS, mesh)(s0), device)
    out = unshard_state(module.make_sharded_runner(cfg, COMPARE_STEPS, mesh)(s0), device)
    kernel = module.__name__.rsplit(".", 1)[1]
    return check_close(f"{kernel} {name} mesh {cfg.mesh_shape}", cfg, out.f, plain.f,
                       out.rho_lid, plain.rho_lid)


def compare_sharded_pull(cfg: SimConfig, device, n: int) -> float:
    """``cuda-sharded`` against ``cuda-pull`` on the global grid over n
    steps: the same arithmetic, the wrap supplied by the halo, so they must
    agree exactly."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = engine.init_state(cfg, device)
    a = unshard_state(pull_sharded.make_sharded_runner(cfg, n, mesh)(
        shard_state(s0, mesh)), device)
    b = pull.make_scan_runner(dataclasses.replace(cfg, mesh_shape=(1, 1)), n, device)(s0)
    return check_close(f"cuda-sharded vs pull_step, {n} steps, mesh {cfg.mesh_shape}",
                       cfg, a.f, b.f, a.rho_lid, b.rho_lid, atol=0.0)


def compare_tblock_sharded_pull(cfg: SimConfig, device, n: int) -> float:
    """The sharded temporal-block kernel against the sharded one-step kernel
    over n steps (blocks of the default K, the remainder through the
    latter)."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = shard_state(engine.init_state(cfg, device), mesh)
    a = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh)(s0), device)
    b = unshard_state(pull_sharded.make_sharded_runner(cfg, n, mesh)(s0), device)
    return check_close(f"tblock_sharded K={tblock_sharded.K_STEPS} vs pull_sharded, "
                       f"{n} steps, mesh {cfg.mesh_shape}", cfg, a.f, b.f,
                       a.rho_lid, b.rho_lid, atol=TBLOCK_VS_PULL_ATOL)


def noisy_state(cfg: SimConfig, device, seed: int = 7) -> engine.State:
    """The start state with seeded noise (1e-3 relative), so that every
    population of every strip moves."""
    s = engine.init_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(s.f.shape, generator=gen, device=device)
    return engine.State(s.f * (1.0 + 1e-3 * noise), s.rho_lid)


def random_carries(device, shape, lay: halo.Layout, seed: int = 7):
    """Carries of the tight layout and their lid panels on a mesh ``shape``
    of this card, filled from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mx, my = shape
    width = lay.lx + 2 * lay.depth

    def blocks(*size):
        return tuple(tuple(torch.rand(size, generator=gen, device=device)
                           for _ in range(my)) for _ in range(mx))

    return blocks(9, width, lay.pitch), blocks(width)


def compare_refresh(device, shape, n: int, k: int, layout: str,
                    x_only: bool = False) -> float:
    """(a) The exchange kernel's whole refresh (``make_halo_exchange``) on an
    n^2 carry set of the ``layout`` layout, K deep (with lid panels on the
    tight layout, as the temporal-block runner has them; without on the
    aligned one, as the one-step runner has them), filled from a seeded
    generator, against its definition, ``halo.refresh_phases`` copied in
    order, on a copy: equal byte for byte (so nothing but the halos and the
    panels of ``iy > 0`` moved), in one launch for the mesh of this card.
    With ``x_only`` the x-only table of the JAX contract
    (``make_x_halo_exchange``) against the x-phase copies."""
    mx, my = shape
    lay = getattr(halo.Layout, layout)(n // mx, n // my, k)
    carries, panels = random_carries(device, shape, lay)
    if layout == "aligned":
        panels = None
    plain = [None if b is None else tuple(tuple(t.clone() for t in col) for col in b)
             for b in (carries, panels)]
    make = halo_rdma.make_x_halo_exchange if x_only else halo_rdma.make_halo_exchange
    exchange = make(sharded_mesh(device, shape), carries, panels, lay)
    before = halo_rdma.launches
    exchange()
    launched = halo_rdma.launches - before
    for phase in ([halo_rdma.x_moves(*plain, lay)] if x_only
                  else halo.refresh_phases(*plain, lay)):
        halo.copy_pairs(halo.move_pairs(phase))
    torch.cuda.synchronize()
    equal = all(torch.equal(got[ix][iy].view(torch.int32), want[ix][iy].view(torch.int32))
                for got, want in zip((carries, panels), plain) if want is not None
                for ix in range(mx) for iy in range(my))
    name = "x-only table" if x_only else "refresh"
    print(f"  halo_exchange {name} {n}^2 {layout} K={k} mesh {shape}"
          f"{' with panels' if panels is not None else ''}: {launched} launch, equal "
          f"byte for byte to its plain version: {equal}", flush=True)
    if launched != 1:
        raise AssertionError(f"halo_exchange: {launched} launches for one card, not 1")
    if not equal:
        raise AssertionError(f"halo_exchange {name} differs from its plain version on "
                             f"{shape}")
    return 0.0


def sharded_copies(cfg: SimConfig, n: int, runner: str) -> int:
    """``halo.copies`` of one call of a sharded runner of ``n`` steps on
    ``cfg``'s mesh of this card when its refresh is the exchange kernel:
    the copies of the blocks and lid densities into the buffers the runner
    keeps and out of them, and the lid density's copies over the columns,
    made once per call; no halo copy per step or block.  ``runner``:
    "pull" or "tblock"."""
    mx, my = cfg.mesh_shape
    shards, over_columns = mx * my, mx * (my - 1)
    if runner == "pull":
        return (4 * shards + over_columns) if n else 0
    rem = n % tblock_sharded.K_STEPS
    return (4 * shards + over_columns) * (n >= tblock_sharded.K_STEPS) + sharded_copies(
        cfg, rem, "pull")


def copy_driven_pull_runner(cfg: SimConfig, n: int, mesh):
    """The one-step sharded runner with its refresh as the two-phase strip
    copies (``halo.halo_pairs``, fixed once per buffer, as ``time_sharded``
    builds them): the same launches, driven as before the exchange kernel
    took the refresh."""
    lay = pull_sharded.layout(*halo.check_mesh(cfg, mesh))

    def run(state):
        carries = [halo.pad_blocks(state.f, lay)]
        carries.append(halo.empty_blocks(carries[0]))
        rows = [halo.pad_rows(state.rho_lid, 0)]
        rows.append(halo.empty_blocks(rows[0]))
        exchange, steps = [], []
        for src in (0, 1):
            dst = 1 - src
            exchange.append(halo.halo_pairs(carries[src], lay))
            steps.append([(mesh.device(ix, iy), pull_sharded._shard_call(
                cfg, lay, carries[src][ix][iy], rows[src][ix][iy],
                halo.edge_flags(mesh.shape, ix, iy), None, carries[dst][ix][iy],
                rows[dst][ix][iy])) for ix, iy in mesh.shards()])
        for i in range(n):
            halo.copy_pairs(exchange[i % 2])
            pull_sharded.run_calls(steps[i % 2])
        out = n % 2
        halo.copy_pairs(halo.replicate_pairs(rows[out]))
        return halo.ShardedState(halo.unpad_blocks(carries[out], lay), rows[out])

    return run


def compare_pull_copies(cfg: SimConfig, device, n: int) -> float:
    """(b) ``cuda-sharded``'s runner (its refresh one exchange launch per
    step) against the copy-driven runner over n steps from a seeded noisy
    state: exact; one exchange launch and no halo copy per step."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = shard_state(noisy_state(cfg, device), mesh)
    before = (halo_rdma.launches, halo.copies)
    a = pull_sharded.make_sharded_runner(cfg, n, mesh)(s0)
    counts = (halo_rdma.launches - before[0], halo.copies - before[1])
    b = copy_driven_pull_runner(cfg, n, mesh)(s0)
    a, b = unshard_state(a, device), unshard_state(b, device)
    print(f"  cuda-sharded runner: {counts[0]} halo_exchange launches and {counts[1]} "
          f"copies in {n} steps", flush=True)
    if counts != (n, sharded_copies(cfg, n, "pull")):
        raise AssertionError(f"cuda-sharded: {counts} exchange launches and copies, "
                             f"expected {(n, sharded_copies(cfg, n, 'pull'))}")
    return check_close(f"cuda-sharded vs its copy-driven form, {n} steps, mesh "
                       f"{cfg.mesh_shape}", cfg, a.f, b.f, a.rho_lid, b.rho_lid, atol=0.0)


def compare_rdma_runner(cfg: SimConfig, device, n: int) -> float:
    """(b) The temporal-block sharded runner with the exchange kernel
    against the one with strip copies, over n steps from a seeded noisy
    state: they move the same values, so they must agree exactly."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    s0 = shard_state(noisy_state(cfg, device), mesh)
    before = (halo_rdma.launches, halo.copies)
    a = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh, halo_impl="rdma")(s0),
                      device)
    counts = (halo_rdma.launches - before[0], halo.copies - before[1])
    b = unshard_state(tblock_sharded.make_sharded_runner(cfg, n, mesh)(s0), device)
    blocks, rem = divmod(n, tblock_sharded.K_STEPS)
    want = (blocks + rem, sharded_copies(cfg, n, "tblock"))
    print(f"  rdma runner: {counts[0]} halo_exchange launches and {counts[1]} copies in "
          f"{n} steps ({blocks} blocks, {rem} remainder steps)", flush=True)
    if counts != want:
        raise AssertionError(f"the rdma runner: {counts} exchange launches and copies, "
                             f"expected {want} (one launch per block and per remainder "
                             "step, no halo copy in the loop)")
    return check_close(f"tblock_sharded rdma vs ppermute, {n} steps, mesh "
                       f"{cfg.mesh_shape}", cfg, a.f, b.f, a.rho_lid, b.rho_lid, atol=0.0)


def ipc_probe(rank: int, device) -> None:
    """Does CUDA IPC map memory between the two processes?  Each offers a
    buffer, opens the other's, reads it and writes into it."""
    mine = torch.full((1 << 20,), float(rank + 1), device=device)
    offers = [None, None]
    dist.all_gather_object(offers, reduce_tensor(mine)[1])
    theirs = rebuild_cuda_tensor(*offers[1 - rank])
    seen = theirs.sum().item()
    theirs[:1] = -1.0
    torch.cuda.synchronize()
    dist.barrier()
    ok = seen == float(2 - rank) * (1 << 20) and mine[0].item() == -1.0
    del theirs
    torch.cuda.synchronize()
    dist.barrier()
    if not ok:
        raise AssertionError(f"rank {rank}: CUDA IPC read {seen}, own first value "
                             f"{mine[0].item()}")


def two_process_run(rank: int, out_path: str) -> None:
    """(c) In each of two processes on the card: the IPC probe; then both
    temporal-block runners on a (2, 1) mesh spanning the processes at
    1024^2 MRT, gathered on rank 0 against the same runner on a mesh of one
    process; then the x phase alone in both forms, with its host ordering.
    Rank 0 writes what it found to ``out_path``."""
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ipc_probe(rank, device)
    cfg = SimConfig(nx=IPC_N, ny=IPC_N, reynolds=5000.0, collision="mrt",
                    precision="float32", mesh_shape=IPC_MESH).validate()
    pod = multihost.make_pod_mesh(IPC_MESH, [device])
    s0 = noisy_state(cfg, device)
    if rank == 0:
        one = sharded_mesh(device, IPC_MESH)
        ref = unshard_state(tblock_sharded.make_sharded_runner(cfg, IPC_STEPS, one)(
            shard_state(s0, one)), device)
    found = {"rank_shards": pod.local_shards()}
    for impl in ("rdma", "ppermute"):
        before = (halo_rdma.launches, halo.sends, halo.staged)
        out = unshard_state(tblock_sharded.make_sharded_runner(
            cfg, IPC_STEPS, pod, halo_impl=impl)(shard_state(s0, pod)), device, pod)
        counts = [a - b for a, b in zip((halo_rdma.launches, halo.sends, halo.staged),
                                        before)]
        found[impl] = {"launches": counts[0], "sends": counts[1], "staged": counts[2]}
        if rank == 0:
            found[impl]["max_abs_err"] = max((out.f - ref.f).abs().max().item(),
                                             (out.rho_lid - ref.rho_lid).abs().max().item())
    k = tblock_sharded.K_STEPS
    lay = halo.Layout.tight(IPC_N // IPC_MESH[0], IPC_N // IPC_MESH[1], k)
    state = shard_state(s0, pod)
    carries, panels = halo.pad_blocks(state.f, lay), halo.pad_rows(state.rho_lid, k)
    forms = {"rdma": halo_rdma.make_x_halo_exchange(pod, carries, panels, lay),
             "ppermute": halo.Transfer(pod, halo_rdma.x_moves(carries, panels, lay))}
    for name in ("rdma", "ppermute", "ppermute", "rdma"):
        forms[name]()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(IPC_EXCHANGE_REPS):
            forms[name]()
        torch.cuda.synchronize()
        found.setdefault(f"{name}_exchange_ms", []).append(
            (time.perf_counter() - t0) * 1e3 / IPC_EXCHANGE_REPS)
    forms["rdma"].close()
    if rank == 0:
        with open(out_path, "w") as fh:
            json.dump(found, fh)


def run_two_processes() -> dict:
    """Spawn the two processes of (c) and return what rank 0 found."""
    with tempfile.TemporaryDirectory() as tmp:
        out_path = f"{tmp}/found.json"
        multihost.spawn(two_process_run, 2, f"{tmp}/store", args=(out_path,),
                        backend="gloo", timeout=300)
        with open(out_path) as fh:
            return json.load(fh)


def time_exchange(cfg: SimConfig, device, state) -> dict:
    """(d) One halo refresh at K=5 on the mesh from ``state``'s carries, in
    turns: the kernel's whole refresh (one launch), its plain version
    (``halo.refresh_phases`` copied phase after phase), the same moves by
    ``copy_pairs`` (the library time), and the x-only table against its
    strips by ``copy_pairs``; each as device ms with the queue held busy and
    host us per call (``busy_time``); and the bounds: each rectangle read
    once and written once at the published rate."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    k = tblock_sharded.K_STEPS
    lay = halo.Layout.tight(cfg.nx // cfg.mesh_shape[0], cfg.ny // cfg.mesh_shape[1], k)
    carries, panels = halo.pad_blocks(state.f, lay), halo.pad_rows(state.rho_lid, k)
    phases = [halo.move_pairs(p) for p in halo.refresh_phases(carries, panels, lay)]
    for pairs in phases:    # the rings hold the flow's values
        halo.copy_pairs(pairs)
    whole = halo.move_pairs(halo.refresh_moves(carries, panels, lay))
    x_only = halo.move_pairs(halo_rdma.x_moves(carries, panels, lay))
    # (call, calls per reading: few enough copies to queue behind the sleep)
    forms = {
        "kernel": (halo_rdma.make_halo_exchange(mesh, carries, panels, lay), EXCHANGE_REPS),
        "plain": (lambda: [halo.copy_pairs(pairs) for pairs in phases], 10),
        "library": (lambda: halo.copy_pairs(whole), 10),
        "x kernel": (halo_rdma.make_x_halo_exchange(mesh, carries, panels, lay),
                     EXCHANGE_REPS),
        "x library": (lambda: halo.copy_pairs(x_only), 20),
    }
    turns = {name: [] for name in forms}
    for name in list(forms) + list(forms)[::-1]:
        fn, reps = forms[name]
        turns[name].append(busy_time(fn, reps))

    def mean(name, i):
        return sum(t[i] for t in turns[name]) / len(turns[name])

    def rect_bytes(pairs):
        return 2 * sum(src.numel() * src.element_size() for _, src in pairs)

    out = dict(ms=mean("kernel", 0), host_us=mean("kernel", 1), plain_ms=mean("plain", 0),
               library_ms=mean("library", 0), bytes=rect_bytes(whole),
               rects=len(whole), x_ms=mean("x kernel", 0), x_host_us=mean("x kernel", 1),
               x_library_ms=mean("x library", 0), x_bytes=rect_bytes(x_only),
               idle_ms=cuda_time_ms(forms["kernel"][0], EXCHANGE_REPS), turns=turns)
    out["bound_ms"] = out["bytes"] / PEAK_BYTES_PER_S * 1e3
    out["x_bound_ms"] = out["x_bytes"] / PEAK_BYTES_PER_S * 1e3
    out["bound_by"] = "bytes"
    return out


def time_runner_pair(runners: dict, state, steps: int) -> dict:
    """ms per step of each of two runners of ``steps`` steps from
    ``state``, end to end on an idle queue (at small sizes the host's
    pace), in turns (first, second, second, first), each called once
    before (a graph's capture out of the turns)."""
    for run in runners.values():
        run(state)
    out = {name: [] for name in runners}
    a, b = runners
    for name in (a, b, b, a):
        out[name].append(cuda_time_ms(lambda: runners[name](state), 1) / steps)
    return out


def busy_step_pair(make, state, steps: int) -> dict:
    """Per step of each of two runners (``make(n)``: both, of ``n`` steps
    per call) from ``state``, with the queue held busy, in turns: the
    device ms of a step (calls of ``2 * steps`` less calls of ``steps``, so
    that the once-per-call padding drops out) and the host us per step of
    the longer call."""
    short, long = make(steps), make(2 * steps)
    out = {name: [] for name in short}
    a, b = short
    for name in (a, b, b, a):
        ms_s, _ = busy_time(lambda: short[name](state), 1)
        ms_l, host_us = busy_time(lambda: long[name](state), 1)
        out[name].append(((ms_l - ms_s) / steps, host_us / (2 * steps)))
    return out


def sharded_bound(cfg: SimConfig, k_steps: int = 1) -> tuple[float, str]:
    """Least ms per step of a sharded kernel over the whole mesh, at the
    published peaks: each shard's carry with its halo ring (k_steps deep)
    and its lid densities read once and its cells written once per launch
    of k_steps steps, or the operations of one step on every cell."""
    mx, my = cfg.mesh_shape
    lx, ly = cfg.nx // mx, cfg.ny // my
    d = k_steps
    per_shard = (36 * (lx + 2 * d) * (ly + 2 * d) + 36 * lx * ly
                 + 2 * 4 * (lx + 2 * d))
    bytes_ms = mx * my * per_shard / k_steps / PEAK_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_CELL_MRT * cfg.nx * cfg.ny / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_sharded(cfg: SimConfig, device, state, k_steps: int | None) -> dict:
    """Device ms per step on the mesh of a sharded kernel's runner
    (``k_steps`` None: the one-step kernel; else the temporal-block one),
    from ``state``: the whole runner; then, on buffers with the runner's
    layout, views and launch arguments, the halo exchange alone and the
    kernel launches alone, these both from buffer to buffer as in the
    runner, so the flow moves on (``ms``), and again and again on the
    same input (``fixed_ms``); and the plain version."""
    mesh = sharded_mesh(device, cfg.mesh_shape)
    lx, ly = cfg.nx // cfg.mesh_shape[0], cfg.ny // cfg.mesh_shape[1]
    if k_steps is None:
        runner = pull_sharded.make_sharded_runner(cfg, SHARDED_STEPS, mesh)
        lay, per_launch = pull_sharded.layout(lx, ly), 1
    else:
        runner = tblock_sharded.make_sharded_runner(
            cfg, SHARDED_STEPS, mesh, k_steps, halo_impl=sim.SHARDED_TBLOCK_HALO_IMPL)
        lay, per_launch = halo.Layout.tight(lx, ly, k_steps), k_steps
    runner(state)
    out = dict(full_ms=cuda_time_ms(lambda: runner(state), 1) / SHARDED_STEPS)
    n = SHARDED_STEPS // per_launch
    carries = [halo.pad_blocks(state.f, lay)]
    rows = [halo.pad_rows(state.rho_lid, 0 if k_steps is None else k_steps)]
    exchange = halo.halo_pairs(carries[0], lay)
    if k_steps is not None:
        exchange += halo.row_halo_pairs(rows[0], k_steps)
    halo.copy_pairs(exchange)
    # the second buffers start as copies, so their rings hold the flow's values
    carries.append(tuple(tuple(c.clone() for c in col) for col in carries[0]))
    rows.append(tuple(tuple(r.clone() for r in col) for col in rows[0]))
    calls = []
    for src in (0, 1):
        dst = 1 - src
        if k_steps is None:
            calls.append([(mesh.device(ix, iy), pull_sharded._shard_call(
                cfg, lay, carries[src][ix][iy], rows[src][ix][iy],
                halo.edge_flags(mesh.shape, ix, iy), None, carries[dst][ix][iy],
                rows[dst][ix][iy])) for ix, iy in mesh.shards()])
        else:
            calls.append([(mesh.device(ix, iy), tblock_sharded._block_call(
                cfg, carries[src][ix][iy], rows[src][ix][iy], (ix * lx, iy * ly),
                carries[dst][ix][iy], rows[dst][ix][iy], k_steps))
                for ix, iy in mesh.shards()])
    out["exchange_ms"] = cuda_time_ms(lambda: halo.copy_pairs(exchange), n) / per_launch
    kernel = halo_rdma.make_halo_exchange(mesh, carries[0], None if k_steps is None
                                          else rows[0], lay)
    ms, host_us = busy_time(kernel, EXCHANGE_REPS)
    out["exchange_kernel_ms"], out["exchange_kernel_host_us"] = ms / per_launch, host_us
    out["fixed_ms"] = cuda_time_ms(lambda: pull_sharded.run_calls(calls[0]), n) / per_launch

    def both():
        pull_sharded.run_calls(calls[0])
        pull_sharded.run_calls(calls[1])

    out["ms"] = cuda_time_ms(both, n // 2) / (2 * per_launch)
    if k_steps is None:
        out["plain_ms"] = time_plain(make_sharded_fused_step(cfg, mesh), state, reps=3)
    else:
        out["plain_ms"] = cuda_time_ms(lambda: [
            tblock_sharded.plain_block(cfg, carries[0][ix][iy], rows[0][ix][iy],
                                       (ix * lx, iy * ly), k_steps)
            for ix, iy in mesh.shards()], 1) / k_steps
    return out


def graph_replays(backend: str, interval: int) -> int:
    """Graph launches of one call of ``backend``'s runner of ``interval``
    steps on one card: its dispatches (0 for the routes that launch no
    kernel of the port)."""
    def per_call(p: graphs.Plan) -> int:
        return sum(times for _, times in p.graphs())

    if backend in ("cuda-pull", "cuda-push", "cuda-sharded"):
        return per_call(graphs.plan(interval))
    if backend == "cuda-tblock":
        return per_call(graphs.plan(interval, tblock.K_STEPS))
    if backend == "cuda-sharded-tblock":
        blocks, rem = divmod(interval, tblock_sharded.K_STEPS)
        return per_call(graphs.plan(blocks)) + per_call(graphs.plan(rem))
    return 0


def reset_counters() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counters() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def run_main_path(cfg: SimConfig, device, out_dir: str, backend: str,
                  expect: str | None, gates: dict | None = None,
                  mlups: list | None = None) -> dict:
    """``simulate`` through ``backend``; checks the route (when ``expect``
    is given), the launches of the routed kernel against the steps, a
    finite field and the Ghia gates.  Returns the launch counts, and
    appends the run's MLUPS to ``mlups`` where given."""
    reset_counters()
    halo.copies = 0
    replays = graphs.replays
    summary = simulate(cfg, SimOptions(out_dir=out_dir, verbose=False,
                                       backend=backend), device=device)
    torch.cuda.synchronize()
    counts = read_counters()
    replays = graphs.replays - replays
    copies = f" halo copies={halo.copies}" if halo.copies else ""
    print(f"  {cfg.describe()} backend={backend}: routed to {summary.backend}, "
          f"steps={summary.steps} launches={counts}{copies} graph launches={replays} "
          f"MLUPS={summary.mlups:.1f} r2_ux={summary.r2_ux} r2_uy={summary.r2_uy} "
          f"l2={summary.l2_combined}", flush=True)
    if expect is not None and summary.backend != expect:
        raise AssertionError(f"routed to {summary.backend!r}, not {expect!r}")
    chunks = summary.steps // cfg.report_interval
    if replays != chunks * graph_replays(summary.backend, cfg.report_interval):
        raise AssertionError(f"{summary.backend}: {replays} graph launches in {chunks} "
                             f"chunks, expected "
                             f"{chunks * graph_replays(summary.backend, cfg.report_interval)}")
    if not math.isfinite(summary.mlups):
        raise AssertionError("non-finite MLUPS")
    if mlups is not None:
        mlups.append(summary.mlups)
    steps, chunks = summary.steps, summary.steps // cfg.report_interval
    blocks, rem = divmod(cfg.report_interval, tblock.K_STEPS)
    s_blocks, s_rem = divmod(cfg.report_interval, tblock_sharded.K_STEPS)
    shards = cfg.mesh_shape[0] * cfg.mesh_shape[1]
    want = {name: 0 for name in COUNTERS}
    rdma = sim.SHARDED_TBLOCK_HALO_IMPL == "rdma"
    one_step = "pull_step_tangential" if cfg.boundary == "nebb_tangential" else "pull_step"
    want.update({
        "cuda-pull": {one_step: steps},
        "cuda-tblock": {"pull_step": chunks * rem, "tblock_step": chunks * blocks},
        "cuda-push": {PUSH_KERNELS.get(cfg.boundary, "push_step"): steps},
        # one exchange launch per step (per block) on the mesh of this card
        "cuda-sharded": {"pull_sharded_step": shards * steps, "halo_exchange": steps},
        "cuda-sharded-tblock": {"pull_sharded_step": shards * chunks * s_rem,
                                "tblock_sharded_step": shards * chunks * s_blocks,
                                "halo_exchange": chunks * (s_rem + s_blocks * rdma)},
    }.get(summary.backend, {}))
    if counts != want:
        raise AssertionError(f"{summary.backend}: launches {counts}, expected {want}")
    kind = {"cuda-sharded": "pull", "cuda-sharded-tblock": "tblock"}.get(summary.backend)
    if kind is not None and (kind == "pull" or rdma):
        # no halo copy per step or block: the runner's copies once per call,
        # and the observables' padding and two-phase exchange (five copies
        # per shard) after each call and at the end
        copies_want = (chunks * sharded_copies(cfg, cfg.report_interval, kind)
                       + (chunks + 1) * 5 * shards)
        if halo.copies != copies_want:
            raise AssertionError(f"{summary.backend}: {halo.copies} halo copies, expected "
                                 f"{copies_want}")
    for key, (op, limit) in (gates or {}).items():
        value = getattr(summary, key)
        ok = {">": value > limit, ">=": value >= limit, "<": value < limit,
              "<=": value <= limit}[op]
        if not ok:
            raise AssertionError(f"Ghia gate failed: {key}={value} not {op} {limit}")
    return counts


def run_converge_path(cfg: SimConfig, device) -> dict:
    """``run_to_convergence``, the package's other entry point: it too must
    launch the kernel once per step and end with a finite field."""
    reset_counters()
    res = lbt.run_to_convergence(cfg, device=device)
    torch.cuda.synchronize()
    counts = read_counters()
    print(f"  run_to_convergence {cfg.describe()}: steps={res.steps} "
          f"launches={counts} mean_u={res.mean_u_history}", flush=True)
    if counts["pull_step"] != res.steps:
        raise AssertionError(f"{counts} kernel launches for {res.steps} steps")
    if not bool(torch.isfinite(res.state.f).all()):
        raise AssertionError("run_to_convergence: non-finite populations")
    return counts


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] += n


def time_runner(runner, state, steps: int) -> float:
    """Device ms per step of ``runner`` (``steps`` steps per call): one
    warm-up call, then one timed call."""
    state = runner(state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = runner(state)
    end.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out[0] if isinstance(out, tuple) else out).all()):
        raise AssertionError("non-finite populations after a timed run")
    return start.elapsed_time(end) / steps


def time_plain(step, state, reps: int = 10) -> float:
    """Device ms per call of a plain step (``state`` is carried)."""
    holder = [step(step(state))]

    def once():
        holder[0] = step(holder[0])

    return cuda_time_ms(once, reps)


def sweep_config(n: int = SWEEP_N, **kw) -> SimConfig:
    """The datagen CLI's cavity (``cli.py`` datagen: SRT + Smagorinsky,
    float32) at ``n``^2."""
    return SimConfig(**{"nx": n, "ny": n, "reynolds": 100.0, "collision": "srt",
                        "turbulence": "smagorinsky", **kw}).validate()


def sweep_start(cfg: SimConfig, n_cav: int, device, seed: int | None = None):
    """``n_cav`` cavities stacked along x from rest (with seeded noise when
    ``seed`` is given), and their omegas: Re from 100 in steps of 150."""
    s = engine.init_state(cfg, device)
    f = s.f.expand(n_cav, *s.f.shape)
    if seed is not None:
        gen = torch.Generator(device=device).manual_seed(seed)
        f = f * (1.0 + 1e-3 * torch.randn(f.shape, generator=gen, device=device))
    state = engine.stack_cavities(engine.State(f, s.rho_lid.expand(n_cav, *s.rho_lid.shape)))
    omegas = [dataclasses.replace(cfg, reynolds=100.0 + 150.0 * c).omega
              for c in range(n_cav)]
    return state, omegas


def cavity(state: engine.State, nx: int, c: int) -> engine.State:
    return engine.State(state.f[:, c * nx:(c + 1) * nx].contiguous(),
                        state.rho_lid[c * nx:(c + 1) * nx].clone())


def compare_sweep(name: str, cfg: SimConfig, n_cav: int, device,
                  seed: int | None) -> float:
    """20 sweep-kernel steps against 20 plain stacked steps."""
    s0, omegas = sweep_start(cfg, n_cav, device, seed)
    plain = engine.make_stacked_step_omega(cfg, n_cav)
    om = torch.tensor(omegas, dtype=torch.float32, device=device)
    s_p = s0
    for _ in range(COMPARE_STEPS):
        s_p = plain(s_p, om)
    s_k = pull.make_sweep_runner(cfg, n_cav, COMPARE_STEPS, device)(s0, omegas)
    start = "rest" if seed is None else "noisy"
    return check_close(f"sweep x{n_cav} {name} from {start}", cfg, s_k.f, s_p.f,
                       s_k.rho_lid, s_p.rho_lid)


def compare_sweep_singles(cfg: SimConfig, device) -> None:
    """The stack of SWEEP_CAV against cavities SWEEP_SINGLES run alone
    through the one-cavity form (the same entry and table) over
    SWEEP_SINGLE_STEPS steps: they must agree exactly."""
    s0, omegas = sweep_start(cfg, SWEEP_CAV, device, seed=3)
    out = pull.make_sweep_runner(cfg, SWEEP_CAV, SWEEP_SINGLE_STEPS, device)(s0, omegas)
    single = pull.make_scan_runner_omega(cfg, SWEEP_SINGLE_STEPS, device)
    for c in SWEEP_SINGLES:
        alone = single(cavity(s0, cfg.nx, c), omegas[c])
        check_close(f"sweep x{SWEEP_CAV} cavity {c} vs alone, {SWEEP_SINGLE_STEPS} steps",
                    cfg, cavity(out, cfg.nx, c).f, alone.f, cavity(out, cfg.nx, c).rho_lid,
                    alone.rho_lid, atol=0.0)


def check_sweep_nan(cfg: SimConfig, device) -> None:
    """One cavity seeded with NaN: every other cavity stays finite and
    equals its run alone."""
    s0, omegas = sweep_start(cfg, SWEEP_CAV, device, seed=4)
    c_nan = SWEEP_NAN_CAVITY
    s0.f[:, c_nan * cfg.nx:(c_nan + 1) * cfg.nx] = float("nan")
    out = pull.make_sweep_runner(cfg, SWEEP_CAV, SWEEP_NAN_STEPS, device)(s0, omegas)
    single = pull.make_scan_runner_omega(cfg, SWEEP_NAN_STEPS, device)
    if not bool(torch.isnan(cavity(out, cfg.nx, c_nan).f).all()):
        raise AssertionError("the NaN cavity did not stay NaN")
    for c in range(SWEEP_CAV):
        if c == c_nan:
            continue
        got, alone = cavity(out, cfg.nx, c), single(cavity(s0, cfg.nx, c), omegas[c])
        if not (bool(torch.isfinite(got.f).all()) and torch.equal(got.f, alone.f)
                and torch.equal(got.rho_lid, alone.rho_lid)):
            raise AssertionError(f"cavity {c} beside the NaN cavity {c_nan} differs from "
                                 "its run alone")
    print(f"  sweep x{SWEEP_CAV} {cfg.nx}x{cfg.ny}: NaN in cavity {c_nan}; the other "
          f"{SWEEP_CAV - 1} finite and equal to their runs alone after {SWEEP_NAN_STEPS} "
          "steps", flush=True)


def max_param_err(a: dict, b: dict) -> float:
    """max |a - b| over every tensor of two state dicts."""
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)


def rel_errors(a: dict, b: dict, base: dict | None = None) -> dict:
    """Per tensor, ||a - b|| / ||b - base|| (``base`` absent: zero)."""
    return {k: float((a[k].cpu() - b[k].cpu()).norm())
            / (float((b[k].cpu() - (0 if base is None else base[k].cpu())).norm()) or 1.0)
            for k in b}


def check_training_gradients(data, device) -> None:
    """The first minibatch's gradients on the card against the CPU's from
    the same weights, TF32 off (the backward under the model's switch), and
    the same backward under cuDNN's global default (TF32 on), for contrast;
    beside them each one's spread from the CPU's float64 gradients, which
    shows the float32 rounding that the deeper layers carry on the CPU
    too."""
    tr_idx, _ = train.train_val_split(len(data.fnet))
    bi = np.random.default_rng(0).permutation(tr_idx)[:models.PRESETS[SERVE_PRESET].batch_size]
    xb, auxb = torch.from_numpy(data.fnet[bi]), torch.from_numpy(data.aux[bi])
    yb = torch.from_numpy(np.ascontiguousarray(data.targets["x"][bi]))
    cpu_model = models.make_model(SERVE_PRESET, seed=0)
    card_model = models.make_model(SERVE_PRESET, seed=0).to(device)
    f64_model = models.make_model(SERVE_PRESET, compute_dtype=torch.float64,
                                  seed=0).to(torch.float64)
    args = [t.to(device) for t in (xb, auxb, yb)]

    def grads(model):
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    loss_cpu = float(train.loss_and_grads([cpu_model], xb, auxb, yb))
    loss_card = float(train.loss_and_grads([card_model], *args))
    train.loss_and_grads([f64_model], *(t.to(torch.float64) for t in (xb, auxb, yb)))
    g_cpu, g_card, g_f64 = grads(cpu_model), grads(card_model), grads(f64_model)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card_model.zero_grad(set_to_none=True)
        train._mse(card_model, *args).backward()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    g_tf32 = grads(card_model)
    errs, tf32_errs = rel_errors(g_card, g_cpu), rel_errors(g_tf32, g_cpu)
    tail = [f"{layer}.weight" for layer in TAIL_LAYERS]
    worst, tf32_best = max(errs[k] for k in tail), min(tf32_errs[k] for k in tail)
    print(f"  gradients card vs CPU from the same weights: loss {loss_card:.9e} / "
          f"{loss_cpu:.9e}; per tensor ||dg|| / ||g|| in {TAIL_LAYERS}: TF32 off at most "
          f"{worst:.3e} (weights; tolerance {GRAD_RTOL:g}), the backward in TF32 at least "
          f"{tf32_best:.3e}; every tensor, TF32 off "
          f"{ {k: float(f'{v:.2e}') for k, v in errs.items()} }", flush=True)
    f64 = {name: rel_errors({k: v.double() for k, v in g.items()}, g_f64)
           for name, g in (("CPU float32", g_cpu), ("card", g_card),
                           ("card, backward in TF32", g_tf32))}
    print("  against the CPU's float64 gradients, per tensor ||dg|| / ||g|| at most "
          "(in the tail weights, in every tensor): " + "; ".join(
              f"{name} {max(e[k] for k in tail):.3e}, {max(e.values()):.3e}"
              for name, e in f64.items()), flush=True)
    if not abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu):
        raise AssertionError(f"training loss card {loss_card} vs CPU {loss_cpu}")
    if not worst <= GRAD_RTOL:
        raise AssertionError(f"training gradients: card vs CPU {errs}")
    if not tf32_best > GRAD_RTOL:
        raise AssertionError("the TF32 backward meets the float32 tolerance: the check "
                             f"cannot tell the two apart ({tf32_errs})")


def run_training(ds, u_lid: float, device, tmp: str) -> dict:
    """(j): ``ml.train`` of ``cnn_eight`` at 384^2, batch 20, on the card:
    both components; one step against the CPU; a resume against the
    uninterrupted run; the (2, 1) mesh of the card against one device; the
    weight files through ``predict_velocity``; and the training step's and
    an epoch's time."""
    preset = models.PRESETS[SERVE_PRESET]
    data = train.prepare_inputs(ds, preset, u_lid=u_lid)
    tr_idx, va_idx = train.train_val_split(len(data.fnet))
    print(f"  {SERVE_PRESET} at {SWEEP_N}^2, batch {preset.batch_size}, "
          f"{preset.optimizer}: {len(tr_idx)} training and {len(va_idx)} validation "
          f"samples", flush=True)
    kw = dict(epochs=TRAIN_EPOCHS, device=device)
    results = {}
    for comp, seed in (("x", 0), ("y", 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = train.train(SERVE_PRESET, data, component=comp, seed=seed, **kw)
        wall = time.perf_counter() - t0
        print(f"  train {comp}: loss {r.history['loss']} val {r.history['val_loss']} "
              f"({wall:.2f} s)", flush=True)
        if not np.isfinite(r.history["loss"] + r.history["val_loss"]).all():
            raise AssertionError(f"train {comp}: non-finite losses {r.history}")
        results[comp] = r

    check_training_gradients(data, device)

    init = results["x"].params
    step = {d: train.train(SERVE_PRESET, data, epochs=1, init_params=init, device=d)
            for d in (device, "cpu")}
    loss_err = abs(step[device].history["loss"][0] - step["cpu"].history["loss"][0])
    p_err = max(rel_errors(step[device].params, step["cpu"].params, init).values())
    print(f"  one step from the same weights, card vs CPU (TF32 off): |dloss| {loss_err:.3e} "
          f"(loss {step['cpu'].history['loss'][0]:.6e}), per tensor ||dp|| / ||update|| at "
          f"most {p_err:.3e} (tolerance {STEP_RTOL:g}), max|dp| "
          f"{max_param_err(step[device].params, step['cpu'].params):.3e}", flush=True)
    if not (loss_err <= 1e-5 * step["cpu"].history["loss"][0] and p_err <= STEP_RTOL):
        raise AssertionError("train: one step on the card differs from the CPU's")

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full = train.train(SERVE_PRESET, data, **kw)
        ckpt = os.path.join(tmp, "train.ckpt")
        train.train(SERVE_PRESET, data, epochs=2, checkpoint_path=ckpt, checkpoint_every=1,
                    device=device)
        resumed = train.train(SERVE_PRESET, data, checkpoint_path=ckpt, **kw)
    finally:
        torch.backends.cudnn.deterministic = before
    same = resumed.history == full.history and max_param_err(resumed.params, full.params) == 0
    print(f"  resume after 2 of {TRAIN_EPOCHS} epochs (cudnn.deterministic): "
          f"{'equal bit for bit' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise AssertionError("train: the resumed run differs from the uninterrupted one")

    dp = train.train(SERVE_PRESET, data, mesh=make_mesh((2, 1), [device] * 2),
                     epochs=TRAIN_EPOCHS)
    single = results["x"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(dp.history["loss"],
                                                        single.history["loss"]))
    worst = max(float(((dp.params[k] - w).abs() - 2e-4 * w.abs()).max())
                for k, w in single.params.items())
    off = sum(int(((dp.params[k] - w).abs() > 1e-6 + 2e-4 * w.abs()).sum())
              for k, w in single.params.items())
    print(f"  mesh (2, 1) of the card vs one device: loss rel {loss_rel:.3e} (1e-4), "
          f"max(|dp| - 2e-4 |p|) {worst:.3e} (1e-6), {off} elements outside", flush=True)
    if not (loss_rel <= 1e-4 and worst <= 1e-6):
        raise AssertionError("train(mesh=...) differs from the single-device run")

    for r in results.values():
        train.save_weights(r, tmp, scalers=data.scalers)
    (px, meta), (py, _) = (train.load_weights(SERVE_PRESET, c, tmp, device=device)
                           for c in ("x", "y"))
    fnet, aux = predict.build_input(SERVE_PRESET, SERVE_RE, ds.feq_initial, meta["scalers"],
                                    u_lid=u_lid)
    u_mem = predict.predict_velocity(SERVE_PRESET, results["x"].params, results["y"].params,
                                     fnet, aux, data.scalers, device=device)
    u_file = predict.predict_velocity(SERVE_PRESET, px, py, fnet, aux, meta["scalers"],
                                      device=device)
    print(f"  save_weights / load_weights / predict_velocity: max|du| "
          f"{float(np.abs(u_file - u_mem).max()):.3e}", flush=True)
    if not np.array_equal(u_file, u_mem):
        raise AssertionError("weights through their files predict another field")

    model = models.make_model(SERVE_PRESET, seed=0).to(device)
    opt = train.Optimizer(preset, model.parameters(), 1e-3)
    bi = torch.from_numpy(tr_idx[:preset.batch_size]).to(device)
    xb, auxb = (torch.from_numpy(a).to(device)[bi] for a in (data.fnet, data.aux))
    yb = torch.from_numpy(np.ascontiguousarray(data.targets["x"])).to(device)[bi]

    def one_step():
        train.loss_and_grads([model], xb, auxb, yb)
        opt.step()

    step_ms = {}
    for tf32 in (False, True, True, False):
        model.allow_tf32 = tf32
        one_step()
        step_ms.setdefault(f"tf32={tf32}", []).append(cuda_time_ms(one_step, TRAIN_REPS))
    del model, opt, xb, auxb, yb
    wall = {}
    for epochs in (1, 1 + TRAIN_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train.train(SERVE_PRESET, data, epochs=epochs, device=device)
        wall[epochs] = time.perf_counter() - t0
    epoch_ms = (wall[1 + TRAIN_EPOCHS] - wall[1]) / TRAIN_EPOCHS * 1e3
    print(f"  training step (forward, backward, RMSprop update), batch {preset.batch_size} "
          f"at {SWEEP_N}^2, in turns: {step_ms} ms; one epoch ({len(tr_idx) // preset.batch_size}"
          f" step and the validation forward over {len(va_idx)}, TF32 off): "
          f"{epoch_ms:.2f} ms (a {1 + TRAIN_EPOCHS}-epoch call less a 1-epoch call)",
          flush=True)


def serve_artifact(ds, device) -> None:
    """The repo's trained ``cnn_nine``, read by ``load_weights`` from the JAX
    package's ``.msgpack`` files (no ``.pt`` beside them) onto the card and
    served at 384^2 on ``build_input`` of (h)'s ``feq_initial`` with the
    sidecar's scalers, against the CPU forward of the same state dicts
    (rtol 1e-4, atol 1e-5, TF32 off); then the JAX training checkpoint
    carried onto the card by ``train._load_train_checkpoint`` under its own
    recipe, as ``train`` resumes it."""
    t0 = time.perf_counter()
    (px, meta), (py, _) = (train.load_weights(ARTIFACT_PRESET, c, ARTIFACT_WEIGHTS,
                                              device=device) for c in "xy")
    load_s = time.perf_counter() - t0
    if {t.device for t in (*px.values(), *py.values())} != {device}:
        raise AssertionError("load_weights did not put the weights on the card")
    fnet, aux = predict.build_input(ARTIFACT_PRESET, SERVE_RE, ds.feq_initial,
                                    meta["scalers"])
    u_card = predict.predict_velocity(ARTIFACT_PRESET, px, py, fnet, aux, meta["scalers"],
                                      device=device)
    u_cpu = predict.predict_velocity(ARTIFACT_PRESET, px, py, fnet, aux, meta["scalers"],
                                     device="cpu")
    if u_card.shape != (2, SWEEP_N, SWEEP_N) or not np.isfinite(u_card).all():
        raise AssertionError(f"predict_velocity: {u_card.shape}, not a finite "
                             f"(2, {SWEEP_N}, {SWEEP_N})")
    err = float(np.abs(u_card - u_cpu).max())
    print(f"  {ARTIFACT_PRESET} from {os.path.relpath(ARTIFACT_WEIGHTS, REPO)}/*.msgpack "
          f"({len(px)} + {len(py)} tensors read in {load_s:.2f} s) at {SWEEP_N}^2 "
          f"Re={SERVE_RE:g}: card vs CPU max|du|={err:.3e} (max|u| "
          f"{np.abs(u_cpu).max():.3e}; rtol 1e-4, atol 1e-5, TF32 off)", flush=True)
    np.testing.assert_allclose(u_card, u_cpu, rtol=1e-4, atol=1e-5)

    with open(ARTIFACT_CKPT, "rb") as fh:
        recipe = json.loads(fh.read(int.from_bytes(fh.read(8), "little")))["recipe"]
    preset = models.PRESETS[recipe["preset"]]
    steps_per_epoch = max(1, len(train.train_val_split(recipe["data_n"])[0])
                          // recipe["batch_size"])
    model = models.make_model(recipe["preset"], seed=recipe["seed"]).to(device)
    opt = train.Optimizer(preset, model.parameters(), recipe["lr"],
                          schedule=recipe["schedule"], clip_norm=recipe["clip_norm"])
    t0 = time.perf_counter()
    loaded = train._load_train_checkpoint(ARTIFACT_CKPT, recipe, device, model, opt,
                                          steps_per_epoch)
    if loaded is None:
        raise AssertionError(f"{ARTIFACT_CKPT}: refused under its own recipe")
    model_sd, opt_sd, count, history, epoch = loaded
    model.load_state_dict(model_sd)
    opt.opt.load_state_dict(opt_sd)
    decode_s = time.perf_counter() - t0
    moments = [t for st in opt_sd["state"].values() for t in st.values()
               if isinstance(t, torch.Tensor) and t.dim() > 0]
    if {t.device for t in (*model_sd.values(), *moments)} != {device}:
        raise AssertionError("the JAX checkpoint was not carried onto the card")
    print(f"  {os.path.relpath(ARTIFACT_CKPT, REPO)}: epoch {epoch}, "
          f"{recipe['optimizer']} {recipe['schedule']} at update {count}; "
          f"{len(history['loss'])} epochs of history; {len(model_sd)} parameter and "
          f"{len(moments)} moment tensors carried into {preset.name}'s layout on the card "
          f"by _load_train_checkpoint in {decode_s:.2f} s", flush=True)


def run_datagen_mesh(device) -> dict:
    """(k): ``generate_dataset`` over a (2, 1) mesh of the card against one
    stack; returns the mesh run's launch counts."""
    cfg = sweep_config(max_steps=MESH_STEPS, report_interval=MESH_STEPS)
    one = ml.generate_dataset(cfg, re_values=MESH_RE, batch_size=len(MESH_RE), device=device)
    reset_counters()
    two = ml.generate_dataset(cfg, re_values=MESH_RE, batch_size=len(MESH_RE),
                              mesh=make_mesh((2, 1), [device] * 2))
    torch.cuda.synchronize()
    counts = read_counters()
    same = all(np.array_equal(getattr(two, k), getattr(one, k))
               for k in ("f_final", "u_final", "failed"))
    print(f"  generate_dataset {len(MESH_RE)} Re at {SWEEP_N}^2, one batch over a (2, 1) mesh "
          f"of the card, {MESH_STEPS} steps: launches={counts}, against one stack: "
          f"{'equal bit for bit' if same else 'DIFFERS'}", flush=True)
    want = {name: 0 for name in COUNTERS}
    want["pull_sweep_step"] = 2 * MESH_STEPS
    if counts != want:
        raise AssertionError(f"generate_dataset on a mesh: launches {counts}, expected {want}")
    if not same or two.failed.any() or not np.isfinite(two.u_final).all():
        raise AssertionError("generate_dataset on a mesh differs from one stack")
    return counts


def push_run_config(wall: str) -> SimConfig:
    """The main path's run of a wall that only the push engines implement:
    48^2 SRT Re=100, 200 steps in two intervals."""
    return SimConfig(nx=48, ny=48, reynolds=100.0, boundary=wall, max_steps=200,
                     report_interval=100)


def ckpt_config(mesh_shape=(1, 1)) -> SimConfig:
    """The cavity of (l): 256^2 MRT at Re 1000, run without a convergence
    stop."""
    return SimConfig(nx=CKPT_N, ny=CKPT_N, reynolds=1000.0, collision="mrt",
                     max_steps=CKPT_STEPS, report_interval=CKPT_INTERVAL,
                     convergence_tol=0.0, mesh_shape=mesh_shape)


def tang_control_config() -> SimConfig:
    """The BC-closure control re1000_512_tang: 512^2 MRT at Re 1000 with the
    tangential lid."""
    return SimConfig(nx=TANG_CONTROL_N, ny=TANG_CONTROL_N, reynolds=1000.0,
                     collision="mrt", boundary="nebb_tangential",
                     max_steps=TANG_CONTROL_STEPS, report_interval=TANG_CONTROL_INTERVAL)


def run_checkpoint_resume(device, tmp: str) -> dict:
    """(l): ``simulate`` with checkpoints at 256^2 MRT, then resumed from
    the middle checkpoint, on ``cuda-pull`` and on ``cuda-sharded`` (a 2x2
    mesh of the card): the final checkpoints equal bit for bit.  Returns
    the launch counts of all four runs."""
    total = {name: 0 for name in COUNTERS}
    middle = CKPT_STEPS - CKPT_EVERY
    for backend, mesh_shape, dev in (("cuda-pull", (1, 1), device),
                                     ("cuda-sharded", SHARDED_MESH, [device] * 4)):
        cfg = ckpt_config(mesh_shape)
        runs = {}
        for name, resume in (("full", None),
                             ("resumed", os.path.join(tmp, backend, "full", "ckpt",
                                                      f"ckpt_{middle:08d}.npz"))):
            reset_counters()
            summary = simulate(cfg, SimOptions(out_dir=os.path.join(tmp, backend, name),
                                               verbose=False, backend=backend,
                                               checkpoint_every=CKPT_EVERY,
                                               resume_from=resume), device=dev)
            torch.cuda.synchronize()
            counts = read_counters()
            add_counts(total, counts)
            runs[name] = summary, counts
        (full, _), (resumed, counts) = runs["full"], runs["resumed"]
        ran = CKPT_STEPS - middle
        shards = mesh_shape[0] * mesh_shape[1]
        want = {name: 0 for name in COUNTERS}
        want.update({"pull_step": ran} if backend == "cuda-pull" else
                    {"pull_sharded_step": shards * ran, "halo_exchange": ran})
        final = f"ckpt_{CKPT_STEPS:08d}.npz"
        with np.load(os.path.join(tmp, backend, "full", "ckpt", final)) as a, \
                np.load(os.path.join(tmp, backend, "resumed", "ckpt", final)) as b:
            same = all(np.array_equal(a[k], b[k]) for k in ("f", "rho_lid", "step"))
            finite = bool(np.isfinite(b["f"]).all())
        print(f"  {backend} {cfg.describe()}: checkpoints every {CKPT_EVERY}, "
              f"{full.steps} steps at {full.mlups:.1f} MLUPS; resumed at step {middle}: "
              f"routed to {resumed.backend}, {resumed.steps} steps, launches={counts}, "
              f"{resumed.mlups:.1f} MLUPS over the {ran} steps it ran; final checkpoint "
              f"{'equal bit for bit' if same else 'DIFFERS'}", flush=True)
        if resumed.backend != backend or counts != want:
            raise AssertionError(f"resume on {backend}: {resumed.backend}, launches {counts}, "
                                 f"expected {want}")
        if not (same and finite and math.isfinite(resumed.mlups)):
            raise AssertionError(f"resume on {backend}: the final checkpoint differs")
    return total


def run_cli(args: list[str]) -> tuple[list[str], float]:
    """``python -m latticeboltzmannsimulations_torch *args`` from the
    repository's root; its stdout lines and wall seconds.  Raises if it
    fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "latticeboltzmannsimulations_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[:1])} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout.splitlines(), wall


# The slow gates' routes under auto (scripts/torch_slow_gates.py): the
# NEBB and tangential lids on the one-step kernel, bounce-back on the push
# kernel.
SLOW_GATE_ROUTES = {"re400_256_mrt": "cuda-pull", "re1000_256_mrt": "cuda-pull",
                    "re100_128_bounce_back": "cuda-push",
                    "re100_128_nebb_tangential": "cuda-pull"}


def load_script(name: str):
    """``scripts/<name>.py`` loaded by path, as its own module."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_slow_gates(device, tmp: str) -> dict:
    """(q): ``scripts/torch_slow_gates.py``'s four gates in process, each
    through ``auto`` with its launches counted (set to 0 just before, read
    just after): the route, one launch of the routed kernel per step, and
    the gate's own bounds; a failed gate fails the script.  Returns the
    launch counts of all four."""
    gates = load_script("torch_slow_gates")
    total = {name: 0 for name in COUNTERS}
    for gate in gates.GATES:
        name, kwargs = gate[0], gate[1]
        reset_counters()
        t0 = time.perf_counter()
        rec = gates.run_gate(*gate, tmp, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counters()
        want = {n: 0 for n in COUNTERS}
        if rec["backend"] == "cuda-pull":
            tangential = kwargs.get("boundary") == "nebb_tangential"
            want["pull_step_tangential" if tangential else "pull_step"] = rec["steps"]
        elif rec["backend"] == "cuda-push":
            want[PUSH_KERNELS[kwargs.get("boundary", "nebb")]] = rec["steps"]
        print(f"  {name}: routed to {rec['backend']}, {rec['steps']} steps (JAX "
              f"{rec['jax_steps']}) in {wall:.2f} s, converged {rec['converged']}, "
              f"{rec['mlups']} MLUPS, launches "
              f"{ {k: v for k, v in counts.items() if v} }; R2(Ux) {rec['r2_ux']} "
              f"(JAX {rec['jax_r2_ux']}, > {rec['r2_min']}), L2 {rec['l2_combined']} "
              f"(JAX {rec['jax_l2_combined']}, < {rec['l2_max']}); ok {rec['ok']}",
              flush=True)
        if rec["backend"] != SLOW_GATE_ROUTES[name]:
            raise AssertionError(f"{name}: routed to {rec['backend']!r}, not "
                                 f"{SLOW_GATE_ROUTES[name]!r}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected {want}")
        if not rec["ok"]:
            raise AssertionError(f"slow gate {name} failed: {rec}")
        add_counts(total, counts)
    return total


PIPE_RE = ("--re-start", "310", "--re-stop", "380")   # one chunk of JAX's record
PIPE_SMALL = ("--grid", "96", "--report-interval", "500")
PIPE_SMALL_STEPS = 1_000               # the plain stacked step: ~13 ms a step at 7 x 96^2
PIPE_FULL_STEPS = 20_000
PIPE_RE_SERVE = 7500.0
PIPE_MODELS = ("cnn_eight", "cnn_nine", "cnn_ten")
PIPE_CNN_TOL = 1e-3


def plain_sweep_runner(cfg: SimConfig, n_cav: int, n_steps: int, device="cuda"):
    """``pull.make_sweep_runner``'s contract through the plain stacked step
    (``engine.make_stacked_step_omega``) on ``device``: the omegas rounded
    as the kernel's cavity table rounds them."""
    step = engine.make_stacked_step_omega(cfg, n_cav)

    def run(state: engine.State, omegas) -> engine.State:
        om = torch.from_numpy(
            pull.cavity_table(cfg, pull._host_omegas(omegas, n_cav))[:, 0].copy()).to(device)
        for _ in range(n_steps):
            state = step(state, om)
        return state

    return run


def read_chunks(out_dir: str) -> dict:
    chunk_dir = os.path.join(out_dir, "chunks")
    return {fn: dict(np.load(os.path.join(chunk_dir, fn)))
            for fn in sorted(os.listdir(chunk_dir))}


def same_chunks(name: str, got: dict, want: dict) -> None:
    """Two runs' chunk files equal: the same files, keys, counters, flags
    and fields bit for bit (max |d| 0)."""
    if list(got) != list(want):
        raise AssertionError(f"{name}: chunk files {list(got)} against {list(want)}")
    for fn in want:
        if sorted(got[fn]) != sorted(want[fn]):
            raise AssertionError(f"{name} {fn}: keys {sorted(got[fn])} against "
                                 f"{sorted(want[fn])}")
        for key, a in want[fn].items():
            b = got[fn][key]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name} {fn} {key}: {b.dtype}{b.shape} against "
                                     f"{a.dtype}{a.shape}")
            d = float(np.abs(b.astype(np.float64) - a.astype(np.float64)).max()) if a.size else 0.0
            if d != 0.0:
                raise AssertionError(f"{name} {fn} {key}: max |d| {d:.3e}, not 0")
        print(f"  {name} {fn}: steps {int(want[fn]['steps'])}, converged "
              f"{int(want[fn]['converged'].sum())}/{len(want[fn]['re'])}, f_final "
              f"{want[fn]['f_final'].shape}: max |df| = 0, every key equal", flush=True)


def run_pipeline_scripts(device, tmp: str) -> dict:
    """(r): the surrogate pipeline's scripts in process.  (a) the 310..370
    chunk of JAX's record at 96^2 (7 cavities, checks every 500 steps) cut
    to a 1 000-step sweep (``scripts/torch_datagen_full.py``) and a
    1 000-step top-up (``scripts/torch_datagen_topup.py``), each pass
    against the same pass with the sweep runner swapped for the plain
    stacked step on the card: chunk files equal bit for bit; (a') the
    chunk at full width (384^2, the scripts' defaults) cut to a 20 000-step
    sweep and a 20 000-step top-up through the kernel: the chunk's keys,
    shapes, finiteness and cumulative steps, the re-run that skips the done
    Re values and launches nothing, the assembly, and
    ``scripts/torch_check_dataset.py``'s fixed fields against JAX's record;
    (b) ``cnn_eight``, ``cnn_nine`` and ``cnn_ten`` at Re = 7500 from the
    tracked weights through ``scripts/torch_predict_extrapolate.py`` on
    (a')'s template, the tracked JAX truth as its cached truth: served at
    the TPU's precision (``tpu_conv_precision``: bfloat16 operands),
    ``cnn_vs_lbm_l2`` against that truth within 1e-3 of JAX's record; the
    float32 numbers beside JAX's; and each surrogate's float32 serving on
    the card against its CPU forward (rtol 1e-4, atol 1e-5, TF32 off).
    Returns the kernel passes' launch counts."""
    full, topup = load_script("torch_datagen_full"), load_script("torch_datagen_topup")
    check = load_script("torch_check_dataset")
    total = {name: 0 for name in COUNTERS}

    def passes(out: str, plain: bool, small: bool) -> list:
        """The sweep and then the top-up into ``out``; each pass's chunks
        and launch counts."""
        size = (*PIPE_SMALL, "--max-steps", str(PIPE_SMALL_STEPS)) if small else (
            "--max-steps", str(PIPE_FULL_STEPS))
        extra = str(PIPE_SMALL_STEPS if small else PIPE_FULL_STEPS)
        grid_args = PIPE_SMALL if small else ()
        kernel_runner = pull.make_sweep_runner
        results = []
        try:
            if plain:
                pull.make_sweep_runner = plain_sweep_runner
            for name, mod, args in (
                    ("sweep", full, [*size, *PIPE_RE, "--out", out]),
                    ("topup", topup, [*grid_args, "--extra-steps", extra, "--data", out])):
                reset_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mod.main(args) != 0:
                    raise AssertionError(f"{name} {args}: exit code not 0")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counters()
                results.append((read_chunks(out), counts))
                print(f"  {'plain' if plain else 'kernel'} {name} "
                      f"{'96^2' if small else '384^2'}: {wall:.2f} s, launches "
                      f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        finally:
            pull.make_sweep_runner = kernel_runner
        return results

    # (a) 96^2: the kernel's two passes against the plain stacked step's
    kern = passes(os.path.join(tmp, "small_kernel"), plain=False, small=True)
    plain = passes(os.path.join(tmp, "small_plain"), plain=True, small=True)
    for (name, want_steps), (k_chunks, k_counts), (p_chunks, p_counts) in zip(
            (("sweep", PIPE_SMALL_STEPS), ("topup", 2 * PIPE_SMALL_STEPS)), kern, plain):
        if any(p_counts.values()):
            raise AssertionError(f"plain {name}: launched a kernel {p_counts}")
        if k_counts != {**{n: 0 for n in COUNTERS}, "pull_sweep_step": PIPE_SMALL_STEPS}:
            raise AssertionError(f"kernel {name}: launches {k_counts}, expected "
                                 f"{PIPE_SMALL_STEPS} of pull_sweep_step")
        same_chunks(f"96^2 {name}: kernel against plain", k_chunks, p_chunks)
        if [int(c["steps"]) for c in k_chunks.values()] != [want_steps]:
            raise AssertionError(f"{name}: steps {[int(c['steps']) for c in k_chunks.values()]}")
        add_counts(total, k_counts)

    # (a') 384^2, the scripts' defaults, through the kernel alone
    out = os.path.join(tmp, "full")
    (s_chunks, s_counts), (t_chunks, t_counts) = passes(out, plain=False, small=False)
    for name, chunks, counts, want_steps in (
            ("sweep", s_chunks, s_counts, PIPE_FULL_STEPS),
            ("topup", t_chunks, t_counts, 2 * PIPE_FULL_STEPS)):
        (fn, c), = chunks.items()
        keys = {"re", "f_final", "u_final", "steps", "converged"} | (
            {"failed"} if name == "sweep" else set())
        if fn != "re000310.0.npz" or set(c) != keys:
            raise AssertionError(f"{name}: chunk {fn} with keys {sorted(c)}")
        if c["re"].tolist() != [310.0 + 10 * i for i in range(7)] or int(c["steps"]) != want_steps:
            raise AssertionError(f"{name}: Re {c['re'].tolist()}, steps {int(c['steps'])}")
        if c["f_final"].shape != (7, 9, SWEEP_N, SWEEP_N) or c["u_final"].shape != (
                7, 2, SWEEP_N, SWEEP_N) or not all(np.isfinite(c[k]).all()
                                                    for k in ("f_final", "u_final")):
            raise AssertionError(f"{name}: fields {c['f_final'].shape} {c['u_final'].shape}")
        if counts["pull_sweep_step"] != PIPE_FULL_STEPS:
            raise AssertionError(f"{name} 384^2: launches {counts}")
        add_counts(total, counts)
    reset_counters()
    if full.main(["--max-steps", str(PIPE_FULL_STEPS), *PIPE_RE, "--out", out]) != 0:
        raise AssertionError("the re-run of the sweep failed")
    if any(read_counters().values()):
        raise AssertionError(f"the re-run launched {read_counters()}: the done Re values "
                             "were not skipped")
    meta_path = os.path.join(out, "metadata.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    with open(check.JAX_RECORD) as fh:
        result = check.compare(meta, json.load(fh))
    fields = {k: v for k, v in result["fields"].items()
              if k not in ("sweep_max_steps", "max_steps")}
    print(f"  384^2 re-run: nothing launched, dataset assembled ({meta['shapes']}); "
          f"torch_check_dataset fields: {fields}; the chunk: {result['chunks']}", flush=True)
    if not all(f["ok"] for f in fields.values()) or len(fields) != 6:
        raise AssertionError(f"torch_check_dataset's fixed fields: {fields}")

    # (b) the three surrogates at Re = 7500 from the tracked weights
    extrapolate = load_script("torch_predict_extrapolate")
    serve_out = os.path.join(tmp, "extrapolation")
    os.makedirs(serve_out)
    truth = extrapolate.jax_truth_path(REPO, PIPE_RE_SERVE)
    shutil.copy(truth, os.path.join(serve_out, os.path.basename(truth)))
    reset_counters()
    t0 = time.perf_counter()
    rc = extrapolate.main(["--re", f"{PIPE_RE_SERVE:g}", "--models", ",".join(PIPE_MODELS),
                           "--data", out, "--out", serve_out])
    wall = time.perf_counter() - t0
    if rc != 0 or any(read_counters().values()):
        raise AssertionError(f"torch_predict_extrapolate: exit code {rc}, launches "
                             f"{read_counters()}")
    with open(os.path.join(serve_out, "summary.json")) as fh:
        summary = json.load(fh)
    for name in PIPE_MODELS:
        rec = summary[name][f"re{PIPE_RE_SERVE:g}"]
        print(f"  {name} Re={PIPE_RE_SERVE:g} on the card: bfloat16 operands: CNN-vs-LBM "
              f"relL2 {rec['bf16_cnn_vs_lbm_l2_jax_truth']} (JAX's record "
              f"{rec['jax_cnn_vs_lbm_l2']}); float32: {rec['cnn_vs_lbm_l2']}, R2(Ux) "
              f"{rec['r2_cnn_ux']} (record {rec['jax_r2_cnn_ux']}), L2 {rec['l2_cnn']} "
              f"(record {rec['jax_l2_cnn']})", flush=True)
        if abs(rec["d_bf16_cnn_vs_lbm_l2_jax_truth"]) > PIPE_CNN_TOL:
            raise AssertionError(f"{name}: {rec}")
    # the float32 serving users get: each surrogate on the card against its
    # CPU forward on the same template and weights, as (i') holds cnn_nine
    feq = datagen.load_dataset(out).feq_initial
    for name in PIPE_MODELS:
        wdir = os.path.join(REPO, extrapolate.WEIGHT_DIRS[name])
        (px, meta), (py, _) = (train.load_weights(name, c, wdir) for c in "xy")
        fnet, aux = predict.build_input(name, PIPE_RE_SERVE, feq, meta["scalers"])
        u_card, u_cpu = (predict.predict_velocity(name, px, py, fnet, aux, meta["scalers"],
                                                  device=d) for d in (device, "cpu"))
        print(f"  {name} Re={PIPE_RE_SERVE:g} float32 serving: card vs CPU max|du|="
              f"{np.abs(u_card - u_cpu).max():.3e} (max|u| {np.abs(u_cpu).max():.3e}; "
              f"rtol 1e-4, atol 1e-5, TF32 off)", flush=True)
        np.testing.assert_allclose(u_card, u_cpu, rtol=1e-4, atol=1e-5)
    print(f"  three surrogates served in {wall:.2f} s; pipeline launches "
          f"{ {k: v for k, v in total.items() if v} }", flush=True)
    return total


# (s): train_full's reduced run and the pipeline runner's split-and-merge
TRAIN_N = 96                            # cnn_one's stride pyramid divides 96 and 48
TRAIN_RE = np.arange(100.0, 1100.0, 100.0)   # Re 500 is one of train_full's HELD_OUT
TRAIN_STEPS = 2_000
TRAIN_ARGS = ("--models", "cnn_one", "--epochs-scale", "0.004", "--early-epochs", "2",
              "--fine-tune-epochs", "0")     # cnn_one at 96^2 and 48^2, two epochs each
# the CPU's run, held to the card's cnn_one (its numbers come before the
# early preset's and do not depend on it)
TRAIN_CPU_ARGS = (*TRAIN_ARGS, "--early-preset", "")
TRAIN_TOL = 1e-3      # rel and abs, card against CPU after two Adam updates
TRAIN_GRAD_RTOL = 1e-4
SPLIT_RE = ("--re-start", "100", "--re-stop", "380")   # four chunks of JAX's record
SPLIT_SWEEP = ("--grid", "96", "--max-steps", "1000", "--report-interval", "500")
SPLIT_TOPUP = ("--grid", "96", "--extra-steps", "1000", "--report-interval", "500")


def train_full_card_vs_cpu(train_full, device, tmp: str) -> dict:
    """(s), in process: a dataset made in the call (ten cavities at 96^2, Re
    100..1000 with train_full's held-out Re 500, 2 000 steps through the
    sweep kernel); on it, ``cnn_one``'s first minibatch gradients on the card
    against the CPU's from the same weights (every tensor to
    ``TRAIN_GRAD_RTOL`` of its norm, TF32 off), and ``torch_train_full.main``
    on the card (``TRAIN_ARGS``) and on the CPU (``TRAIN_CPU_ARGS``, from the
    same initial weights): ``cnn_one``'s epochs, validation MSEs and
    held-out numbers within ``TRAIN_TOL``.  Returns the kernel launches."""
    cfg = SimConfig(nx=TRAIN_N, ny=TRAIN_N, reynolds=1000.0, collision="srt",
                    turbulence="smagorinsky", precision="float32", max_steps=TRAIN_STEPS,
                    report_interval=TRAIN_STEPS // 2, convergence_tol=1e-7).validate()
    reset_counters()
    ds = ml.generate_dataset(cfg, TRAIN_RE, batch_size=len(TRAIN_RE), device=device)
    counts = read_counters()
    if counts != {**{n: 0 for n in COUNTERS}, "pull_sweep_step": TRAIN_STEPS}:
        raise AssertionError(f"the training dataset: launches {counts}")
    data_dir = os.path.join(tmp, "data")
    ml.save_dataset(ds, data_dir)

    train_ds, held = train_full.split_dataset(ds, train_full.HELD_OUT)
    data = train.prepare_inputs(train_ds, models.PRESETS["cnn_one"], u_lid=cfg.u_lid)
    tr_idx, _ = train.train_val_split(len(data.fnet))
    bi = np.random.default_rng(0).permutation(tr_idx)[:models.PRESETS["cnn_one"].batch_size]
    batch = [None if a is None else torch.from_numpy(np.ascontiguousarray(a[bi]))
             for a in (data.fnet, data.aux, data.targets["x"])]    # cnn_one has no aux
    grads = {}
    for dev in ("cpu", device):
        model = models.make_model("cnn_one", seed=0).to(dev)
        loss = float(train.loss_and_grads([model], *(None if t is None else t.to(dev)
                                                     for t in batch)))
        grads[str(dev)] = (loss, {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (loss_cpu, g_cpu), (loss_card, g_card) = grads["cpu"], grads[str(device)]
    errs = rel_errors(g_card, g_cpu)
    print(f"  cnn_one {TRAIN_N}^2, held out {sorted(held)}: first minibatch loss card "
          f"{loss_card:.9e} CPU {loss_cpu:.9e}; gradients per tensor ||dg|| / ||g|| at most "
          f"{max(errs.values()):.3e} (tolerance {TRAIN_GRAD_RTOL:g}, TF32 off)", flush=True)
    if not abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu) or max(errs.values()) > TRAIN_GRAD_RTOL:
        raise AssertionError(f"cnn_one gradients card against CPU: {errs}")

    summaries = {}
    for dev, args in (("cuda", TRAIN_ARGS), ("cpu", TRAIN_CPU_ARGS)):
        out = os.path.join(tmp, f"train_{dev}")
        reset_counters()
        t0 = time.perf_counter()
        if train_full.main([*args, "--data", data_dir, "--out", out, "--device", dev]):
            raise AssertionError(f"torch_train_full on {dev}: exit code not 0")
        if any(read_counters().values()):
            raise AssertionError(f"training launched a kernel of the port: {read_counters()}")
        with open(os.path.join(out, "summary.json")) as fh:
            summaries[dev] = json.load(fh)["models"]
        print(f"  torch_train_full {shlex.join(args)} --device {dev}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    card, cpu = summaries["cuda"], summaries["cpu"]
    if sorted(card) != ["cnn_one", "cnn_one_192"] or sorted(cpu) != ["cnn_one"]:
        raise AssertionError(f"the summaries' models: card {sorted(card)}, CPU {sorted(cpu)}")
    keep = ("epochs", "final_val_mse", "held_out_eval")
    worst = train_full.hold_close({k: card["cnn_one"][k] for k in keep},
                                  {k: cpu["cnn_one"][k] for k in keep},
                                  TRAIN_TOL, TRAIN_TOL, "cnn_one")
    print(f"  cnn_one: card against CPU from the same weights, largest difference "
          f"{worst:.3e} (rel and abs {TRAIN_TOL:g}); held out "
          f"{[(r['re'], r['r2_ux'], r['rel_l2']) for r in card['cnn_one']['held_out_eval']]}"
          f"; final val MSE {card['cnn_one']['final_val_mse']}; the card's cnn_one_192: loss "
          f"{card['cnn_one_192']['first_loss']:.4e} -> {card['cnn_one_192']['final_loss']:.4e}",
          flush=True)
    if [r["re"] for r in card["cnn_one"]["held_out_eval"]] != [500.0]:
        raise AssertionError(f"held out: {card['cnn_one']['held_out_eval']}")
    truth_path = os.path.join(tmp, "train_cuda", train_full.TRUTH)
    with np.load(truth_path) as z:
        if "feq_initial" in z.files:
            raise AssertionError("the kept truth stored feq_initial: the card's dataset's "
                                 "differs from the configuration's")
    rescored = train_full.score_saved("cnn_one", os.path.join(tmp, "train_cuda", "cnn_one"),
                                      train_full.load_truth(truth_path), lambda msg: None, device)
    worst = train_full.hold_close(rescored["held_out_eval"], card["cnn_one"]["held_out_eval"],
                                  0.0, 1e-5, "rescored")
    print(f"  the kept truth ({os.path.getsize(truth_path)} bytes) re-read and the saved halves "
          f"scored on the card: largest difference to the in-run evaluation {worst:.1e}",
          flush=True)
    if not np.isfinite([card["cnn_one_192"]["first_loss"], card["cnn_one_192"]["final_loss"]]).all():
        raise AssertionError(f"cnn_one_192: {card['cnn_one_192']}")
    return counts


def run_train_scripts(device, tmp: str) -> dict:
    """(s): ``scripts/torch_train_full.py`` and ``scripts/torch_pipeline_cards.py``.
    Four chunks of JAX's record at 96^2 (a 1 000-step sweep and a 1 000-step
    top-up) in process in one directory; then the pipeline runner as a
    subprocess on two ranges of this one card (``--cards 0,0``) on the same
    chunks, while ``train_full_card_vs_cpu`` runs in this process; then the
    runner's chunk files and assembled arrays against the one directory's,
    bit for bit, and its dataset check and its determinism check of its
    merge against that directory's record passed.  Returns the in-process
    kernel launches."""
    train_full = load_script("torch_train_full")
    full, topup = load_script("torch_datagen_full"), load_script("torch_datagen_topup")
    total = {name: 0 for name in COUNTERS}

    one = os.path.join(tmp, "one")
    reset_counters()
    for mod, args in ((full, [*SPLIT_SWEEP, *SPLIT_RE, "--out", one]),
                      (topup, [*SPLIT_TOPUP, "--data", one]),
                      (full, [*SPLIT_SWEEP, *SPLIT_RE, "--out", one])):
        if mod.main(args) != 0:
            raise AssertionError(f"{args}: exit code not 0")
    counts = read_counters()
    if counts != {**{n: 0 for n in COUNTERS}, "pull_sweep_step": 4 * 2 * 1000}:
        raise AssertionError(f"the one directory's sweep and top-up: launches {counts}")
    add_counts(total, counts)

    cards, records = os.path.join(tmp, "cards"), os.path.join(tmp, "records")
    log_path = os.path.join(tmp, "pipeline_cards.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "torch_pipeline_cards.py"),
             "--out", cards, "--records", records, "--cards", "0,0", *SPLIT_RE[2:],
             "--record", os.path.join(one, "metadata.json"),
             "--determinism-record", os.path.join(one, "metadata.json"),
             "--sweep-args", " ".join(SPLIT_SWEEP), "--topup-args", " ".join(SPLIT_TOPUP),
             "--jobs", ""], cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        add_counts(total, train_full_card_vs_cpu(train_full, device, tmp))
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as fh:
            raise AssertionError(f"torch_pipeline_cards: exit code {rc}\n{fh.read()[-6000:]}")
    with open(os.path.join(records, "driver.json")) as fh:
        driver = json.load(fh)
    same_chunks("two ranges of the card, merged, against one directory", read_chunks(cards),
                read_chunks(one))
    for name in ("Re_range.npy", "feq_initial.npy", "f_final.npy", "u_final.npy"):
        a, b = (np.load(os.path.join(d, name)) for d in (one, cards))
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"the merged {name} differs from one directory's")
    print(f"  torch_pipeline_cards --cards 0,0: ranges "
          f"{[(r['re_start'], r['re_stop']) for r in driver['ranges']]}, processes "
          f"{[(p['name'], p['rc'], p['seconds']) for p in driver['processes']]}, {wall:.2f} s "
          f"(the training above ran meanwhile); the one directory's passes launched "
          f"{counts['pull_sweep_step']} pull_sweep_step; merged and assembled arrays equal "
          f"bit for bit", flush=True)
    return total


# (t): the pipeline runner's epoch estimates (torch_pipeline_cards.EPOCH_S):
# each key's model at its grid and batch on the 500-cavity dataset less
# train_full's seven held-out Re, Adam (train_full's --optimizer), TF32 off,
# timed by scripts/torch_train_epochs.py on this one card
EPOCH_FACTOR = 2.0    # an EPOCH_S more than this far from the reading fails


def time_training_epochs(device) -> None:
    """(t): one epoch of each of the pipeline runner's training jobs'
    models (every key of its ``EPOCH_S`` but the ones over several cards,
    which this one card cannot read) as ``ml.train.train`` runs it:
    ``torch_train_epochs.epoch_seconds``, its training steps and one
    forward over the validation cavities (the fastest of its timed blocks)
    on a random dataset of one batch made in the call.  Printed beside the runner's ``EPOCH_S``; fails if
    that is more than ``EPOCH_FACTOR`` from the reading (its values for
    ``cnn_eight`` and ``cnn_one_192`` are whole training runs' times,
    start-up included)."""
    drv = load_script("torch_pipeline_cards")
    epochs = load_script("torch_train_epochs")
    for key, est in drv.EPOCH_S.items():
        if "@" in key:
            print(f"  {key}: {est} s an epoch over several cards, not read on one card",
                  flush=True)
            continue
        r = epochs.epoch_seconds(key, [device])
        print(f"  {key}: {r['preset']} at {r['grid']}^2, batch {r['batch']}: step "
              f"{r['step_ms']:.3f} ms x {r['steps']} + validation forward {r['val_ms']:.3f} ms "
              f"= {r['epoch_s']:.4f} s an epoch; the pipeline runner's EPOCH_S {est} "
              f"({est / r['epoch_s']:.3f}x)", flush=True)
        if not r["epoch_s"] / EPOCH_FACTOR <= est <= r["epoch_s"] * EPOCH_FACTOR:
            raise AssertionError(f"torch_pipeline_cards.EPOCH_S[{key!r}] = {est} s against a "
                                 f"reading of {r['epoch_s']:.4f} s an epoch")


# (u): the scripts of the other runs that read the whole dataset
# (resume_eight_y, train_eight_faithful, train_early_presets,
# diagnose_cnn_eight) on a dataset made in the call, card against CPU; and
# the determinism of the port's sweep: chunk Re 520-580 of its whole-sweep
# record rebuilt at 384^2 (290 000 steps there, all seven cavities
# converged), which must equal that record exactly.
DET_RE = ("--re-start", "520", "--re-stop", "590")
WHOLE_N = 192                       # cnn_eight's stride pyramid divides 192
# train_full holds out Re 500, 1500, 2500 and 5000 of these; the early
# presets and the diagnosis evaluate at Re 5000
WHOLE_RE = np.array([100.0, 300.0, 500.0, 700.0, 900.0, 1100.0, 1300.0, 1500.0, 2500.0, 5000.0])
WHOLE_STEPS = 2_000
WHOLE_EPOCHS = 2
# each script, its arguments and the summary it writes under its --out
WHOLE_RUNS = (
    ("torch_resume_eight_y", (), "summary.json"),
    ("torch_train_eight_faithful", (), os.path.join("cnn_eight_faithful", "summary.json")),
    ("torch_train_early_presets", ("--models", "cnn_two,cnn_four", "--epochs",
                                   str(WHOLE_EPOCHS), "--seven-384-epochs", "0"), "summary.json"),
    ("torch_diagnose_cnn_eight", ("--epochs", str(WHOLE_EPOCHS), "--only", "base150,msfront"),
     "summary.json"),
)


def check_sweep_determinism(tmp: str) -> dict:
    """(u): ``scripts/torch_datagen_full.py`` on chunk Re 520-580 in process
    (the sweep kernel, its launches counted), assembled partially, and
    ``scripts/torch_check_dataset_determinism.py --assemble-partial`` of it
    against the port's whole-sweep record: the chunk's steps, converged and
    failed counts must equal the record's.  Returns the launches."""
    full = load_script("torch_datagen_full")
    check = load_script("torch_check_dataset_determinism")
    out = os.path.join(tmp, "det520")
    reset_counters()
    t0 = time.perf_counter()
    if full.main([*DET_RE, "--out", out]) != 0:
        raise AssertionError("torch_datagen_full on chunk Re 520-580: exit code not 0")
    counts = read_counters()
    wall = time.perf_counter() - t0
    if full.main([*DET_RE, "--out", out, "--assemble-partial"]) != 0:
        raise AssertionError("the partial assembly of chunk Re 520-580: exit code not 0")
    result = os.path.join(tmp, "det520.json")
    rc = check.main([os.path.join(out, "metadata.json"), check.RECORD, "--assemble-partial",
                     "--out", result])
    with open(result) as fh:
        res = json.load(fh)
    with open(os.path.join(out, "metadata.json")) as fh:
        (chunk,) = json.load(fh)["chunks"]
    print(f"  chunk Re 520-580 rebuilt at 384^2 in {wall:.2f} s: {chunk['steps']} steps, "
          f"{chunk['converged']} of {chunk['of']} converged, {chunk['failed']} failed; launches "
          f"{ {k: v for k, v in counts.items() if v} }; against the port's whole-sweep record "
          f"({res['compared']} of its {res['of']} chunks compared): "
          f"{'DETERMINISTIC' if res['deterministic'] else res['mismatches']}", flush=True)
    if counts != {**{n: 0 for n in COUNTERS}, "pull_sweep_step": chunk["steps"]}:
        raise AssertionError(f"the rebuild's launches {counts}, {chunk['steps']} steps")
    if rc != 0 or not res["deterministic"] or (res["compared"], res["agree"]) != (1, 1):
        raise AssertionError(f"chunk Re 520-580 differs from the port's record: {res}")
    return counts


def run_whole_dataset_scripts(device, tmp: str) -> dict:
    """(u): ten cavities at 192^2 made in the call through the sweep kernel
    (``WHOLE_STEPS``), and on them each of ``WHOLE_RUNS`` in process on the
    card and on the CPU, from the same initial weights (the preset's seed;
    ``resume_eight_y`` from the same x weights, trained on the card by
    ``torch_train_full.py``), cut to ``WHOLE_EPOCHS`` epochs a run: the
    summaries within ``TRAIN_TOL`` but their seconds, no kernel of the port
    launched by the training.  Returns the dataset's launches."""
    cfg = SimConfig(nx=WHOLE_N, ny=WHOLE_N, reynolds=1000.0, collision="srt",
                    turbulence="smagorinsky", precision="float32", max_steps=WHOLE_STEPS,
                    report_interval=WHOLE_STEPS // 2, convergence_tol=1e-7).validate()
    reset_counters()
    ds = ml.generate_dataset(cfg, WHOLE_RE, batch_size=len(WHOLE_RE), device=device)
    counts = read_counters()
    if counts != {**{n: 0 for n in COUNTERS}, "pull_sweep_step": WHOLE_STEPS}:
        raise AssertionError(f"the whole-dataset scripts' dataset: launches {counts}")
    data_dir = os.path.join(tmp, "data")
    ml.save_dataset(ds, data_dir)
    with open(os.path.join(data_dir, "metadata.json"), "w") as fh:
        json.dump({"u_lid": cfg.u_lid}, fh)

    # cnn_eight's x half, which resume_eight_y evaluates beside its y half
    train_full = load_script("torch_train_full")
    x_out = os.path.join(tmp, "x")
    if train_full.main(["--models", "cnn_eight", "--components", "x", "--epochs-scale",
                        str(WHOLE_EPOCHS / models.PRESETS["cnn_eight"].epochs),
                        "--early-preset", "", "--fine-tune-epochs", "0", "--data", data_dir,
                        "--out", x_out]):
        raise AssertionError("torch_train_full of cnn_eight's x half: exit code not 0")
    train_fn = train.train
    for name, args, summary in WHOLE_RUNS:
        mod = load_script(name)
        got = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, name, dev)
            if name == "torch_resume_eight_y":
                shutil.copytree(os.path.join(x_out, "cnn_eight"), os.path.join(out, "cnn_eight"))
                train.train = functools.partial(train_fn, epochs=WHOLE_EPOCHS)
            if name == "torch_train_eight_faithful":
                mod.EPOCHS = WHOLE_EPOCHS
            reset_counters()
            t0 = time.perf_counter()
            try:
                rc = mod.main([*args, "--data", data_dir, "--out", out, "--device", dev])
            finally:
                train.train = train_fn
            if rc:
                raise AssertionError(f"{name} --device {dev}: exit code {rc}")
            if any(read_counters().values()):
                raise AssertionError(f"{name} launched a kernel of the port: {read_counters()}")
            with open(os.path.join(out, summary)) as fh:
                got[dev] = drop_keys(json.load(fh), ("train_s", "d_train_s", "device"))
            print(f"  {name} {shlex.join(args)} --device {dev}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        worst = train_full.hold_close(got["cuda"], got["cpu"], TRAIN_TOL, TRAIN_TOL, name)
        print(f"  {name}: card against CPU from the same weights, largest difference "
              f"{worst:.3e} (rel and abs {TRAIN_TOL:g})", flush=True)
    return counts


def drop_keys(obj, keys):
    """``obj`` without ``keys`` at any depth."""
    if isinstance(obj, dict):
        return {k: drop_keys(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [drop_keys(v, keys) for v in obj]
    return obj


# (v): the last three scripts at a cut scale: one probe run at 96^2 in two
# intervals, the rollup over its log, and weak scaling on 64^2 shards.
PROBE_CUT = ("re400_192_srt", 96, 400.0, "srt", "none", 0.08, 4_000)
PROBE_CUT_INTERVAL = 2_000
WEAK_BLOCK = 64
WEAK_MESHES = ((1, 1), (2, 2))
WEAK_STEPS = 1_000                  # steps per runner call
WEAK_MIN_TIMED = 3_000              # steps per timing
WEAK_REPS = 1


def _interval_rows(path: str) -> list:
    """A metrics log's interval rows without their wall-clock stamp."""
    with open(path) as fh:
        return [drop_keys(json.loads(line), ("t",)) for line in fh
                if line.strip() and not json.loads(line).get("final")]


def run_last_scripts(device, tmp: str) -> dict:
    """(v): ``scripts/torch_probe_fidelity.py``'s run cut to ``PROBE_CUT``
    through ``auto``, its launches counted, held bit for bit to the same run
    through ``simulate(backend="cuda-pull")`` (steps, R2(Ux), L2 and every
    interval's row of the log); ``scripts/torch_rollup_validation.py`` over
    that run's log (its row the probe's, rounded as JAX rounds, with the
    route and the card; JAX's six unscripted rows without a port row); and
    ``scripts/torch_weak_scaling_cpu.py``'s measurement on ``WEAK_MESHES`` of
    ``WEAK_BLOCK``^2 shards, each routed to ``cuda-sharded`` against
    ``cuda-pull`` with its launches counted and its final state equal to
    ``cuda-pull``'s after the same steps (``measure`` raises where it is
    not; the 1x1 mesh's halo wraps onto its one shard).  Returns the
    launches of the probe run and the weak-scaling runs."""
    probe = load_script("torch_probe_fidelity")
    rollup = load_script("torch_rollup_validation")
    weak = load_script("torch_weak_scaling_cpu")
    total = {name: 0 for name in COUNTERS}
    runs = os.path.join(tmp, "runs", "validation")
    name, nx, reynolds, collision, turbulence, u_lid, max_steps = PROBE_CUT

    reset_counters()
    t0 = time.perf_counter()
    row = probe.run(*PROBE_CUT, interval=PROBE_CUT_INTERVAL, out_root=runs, device=device)
    counts = read_counters()
    wall = time.perf_counter() - t0
    if row["backend"] != "cuda-pull" or counts != {**{n: 0 for n in COUNTERS},
                                                   "pull_step": row["steps"]}:
        raise AssertionError(f"the probe run: route {row['backend']}, launches {counts}")
    add_counts(total, counts)
    cfg = SimConfig(nx=nx, ny=nx, reynolds=reynolds, collision=collision, turbulence=turbulence,
                    u_lid=u_lid, precision="float32", max_steps=max_steps,
                    report_interval=PROBE_CUT_INTERVAL).validate()
    direct_dir = os.path.join(tmp, "direct")
    direct = simulate(cfg, SimOptions(out_dir=direct_dir, project=name, save_plots=False,
                                      backend="cuda-pull", verbose=False), device=device)
    got = (row["steps"], row["converged"], row["r2_ux"], row["l2_pct"])
    want = (direct.steps, direct.converged, direct.r2_ux, 100 * direct.l2_combined)
    log = os.path.join(runs, name, f"{name}_metrics.jsonl")
    same_log = _interval_rows(log) == _interval_rows(
        os.path.join(direct_dir, f"{name}_metrics.jsonl"))
    print(f"  probe {name} cut to {nx}^2, {max_steps} steps in {PROBE_CUT_INTERVAL}-step "
          f"intervals: routed to {row['backend']} in {wall:.2f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }; steps, converged, R2(Ux), L2 % {got}; "
          f"simulate on cuda-pull {want}; interval rows equal: {same_log}", flush=True)
    if got != want or not same_log or row["steps"] != max_steps:
        raise AssertionError(f"the probe run {got} is not simulate's on cuda-pull {want}")

    with open(os.path.join(tmp, "probes.json"), "w") as fh:   # as the probe's main writes it
        json.dump([row], fh)
    if rollup.main(art=tmp) != 0:
        raise AssertionError("torch_rollup_validation: exit code not 0")
    with open(os.path.join(tmp, "validation_rollup.json")) as fh:
        rows = json.load(fh)
    ours = [r for r in rows if r["port"] is not None]
    mine = {"run": name, "steps": row["steps"], "r2_ux": round(row["r2_ux"], 5),
            "l2_pct": round(row["l2_pct"], 3), "mlups": round(row["mlups"], 1),
            "backend": "cuda-pull", "card": row["card"]}
    print(f"  rollup: {json.dumps(ours)}; {len(rows) - len(ours)} JAX rows with no script",
          flush=True)
    if (len(ours) != 1 or {k: ours[0][k] for k in mine} != mine
            or sorted(r["run"] for r in rows if r["port"] is None) != sorted(rollup.NO_SCRIPT)):
        raise AssertionError(f"the rollup's rows {rows}, expected the probe's {mine}")

    for mx, my in WEAK_MESHES:
        reset_counters()
        rec = weak.measure(mx, my, device, steps=WEAK_STEPS, block=WEAK_BLOCK, reps=WEAK_REPS,
                           min_timed_steps=WEAK_MIN_TIMED)
        counts = read_counters()
        steps = (1 + WEAK_REPS * rec["calls"]) * WEAK_STEPS     # the warm call and the timings
        # one exchange a step on every mesh, the 1x1 mesh's self-wrap too
        want = {**{n: 0 for n in COUNTERS}, "pull_sharded_step": steps * mx * my,
                "halo_exchange": steps, "pull_step": steps}
        print(f"  weak scaling {rec['mesh']} of {WEAK_BLOCK}^2 shards: {rec['route']} "
              f"{rec['ns_per_site_step']:.5f} ns/site/step against {rec['control_route']} "
              f"{rec['unsharded_ns_per_site_step']:.5f} (sharding overhead "
              f"{rec['sharding_overhead_pct']} %) over {rec['timed_steps']} steps, final state "
              f"equal to the control's: {rec['equal_to_control']}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        if (rec["route"], rec["control_route"]) != ("cuda-sharded", "cuda-pull") or counts != want:
            raise AssertionError(f"weak scaling {rec['mesh']}: routes {rec['route']}, "
                                 f"{rec['control_route']}, launches {counts}, expected {want}")
        if not (rec["ns_per_site_step"] > 0 and rec["unsharded_ns_per_site_step"] > 0):
            raise AssertionError(f"weak scaling {rec['mesh']}: {rec}")
        add_counts(total, counts)
    return total


def run_bench_command(pull_mlups: float) -> None:
    """(p): ``python -m latticeboltzmannsimulations_torch bench`` as a
    subprocess: exactly one stdout line, ``bench.py``'s four keys, the
    benchmark's cavity on ``cuda-pull``, a positive value; printed beside
    the timing phase's ``pull_step`` MLUPS (CUDA events) of this call."""
    lines, wall = run_cli(["bench"])
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines on stdout: {lines}")
    rec = json.loads(lines[0])
    metric = f"MLUPS {BENCH_N}x{BENCH_N} D2Q9 MRT cavity (cuda-pull)"
    if (set(rec) != {"metric", "value", "unit", "vs_baseline"} or rec["metric"] != metric
            or rec["unit"] != "MLUPS" or not rec["value"] > 0):
        raise AssertionError(f"bench printed {rec}, expected {metric!r} with a value")
    print(f"  bench: {lines[0]} ({wall:.2f} s wall for the command); "
          f"{rec['value'] / pull_mlups:.4f} of the timing phase's pull_step "
          f"{pull_mlups:.1f} MLUPS by CUDA events", flush=True)


def read_trace(path: str, steps: int) -> dict:
    """A ``simulate`` profile of a ``steps``-step chunk on ``cuda-pull``:
    ``pull_step``'s kernel events (exactly ``steps`` of them, from the
    chunk's graph), their device ms per step, the chunk's span, its idle
    share (1 - device busy / span; and from the first kernel's start to the
    last one's end), the host's median us between launches while it
    captures the graph, and the graph launches."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events
               if e.get("cat") == "kernel" and f"{PULL_KERNEL}(" in e.get("name", "")]
    busy = [e for e in events if e.get("cat") in DEVICE_EVENTS]
    chunks = [e for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == sim.CHUNK_SPAN]
    # the chunk is the runner's first call: its launches are captured (a
    # cudaLaunchKernel each, on the host only), then replayed as graphs
    launches = sorted(e["ts"] for e in events
                      if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaLaunchKernel")
    graph_launches = [e for e in events if e.get("cat") == "cuda_runtime"
                      and e.get("name", "").startswith("cudaGraphLaunch")]
    if len(kernels) != steps or len(chunks) != 1:
        raise AssertionError(f"{path}: {len(kernels)} {PULL_KERNEL} events (expected {steps}) "
                             f"and {len(chunks)} chunk spans; the trace has "
                             f"{sorted({e.get('cat') for e in events}, key=str)}, kernels "
                             f"{sorted({e['name'] for e in events if e.get('cat') == 'kernel'})}")
    busy_us = sum(e["dur"] for e in busy)
    first = min(e["ts"] for e in kernels)
    last = max(e["ts"] + e["dur"] for e in kernels)
    return {"kernel_ms_per_step": sum(e["dur"] for e in kernels) / steps / 1e3,
            "chunk_ms": chunks[0]["dur"] / 1e3,
            "idle_share": 1 - busy_us / chunks[0]["dur"],
            "idle_share_between_kernels": 1 - busy_us / (last - first),
            "host_us_per_captured_launch": float(np.median(np.diff(launches))),
            "graph_launches": len(graph_launches),
            "other_device_events": len(busy) - len(kernels)}


def cli_config(n: int, reynolds: float) -> SimConfig:
    """The cavity of ``run --nx n --re reynolds --collision mrt --max-steps
    CLI_STEPS --interval CLI_INTERVAL`` (the command's defaults)."""
    return SimConfig(nx=n, ny=n, reynolds=reynolds, u_lid=0.08, collision="mrt",
                     boundary="nebb", turbulence="none", precision="float32",
                     max_steps=CLI_STEPS, report_interval=CLI_INTERVAL).validate()


def simulate_in_turns(cfg: SimConfig, device, tmp: str, variants: dict,
                      order: list[str]) -> tuple[dict, dict]:
    """In-process ``simulate`` of ``cfg`` with each variant's options, in
    ``order``; each run must launch ``pull_step`` once per step and nothing
    else.  Returns each variant's (summary, output directory, wall seconds
    of the call) and the launch counts of all."""
    total = {name: 0 for name in COUNTERS}
    want = {name: 0 for name in COUNTERS}
    want["pull_step"] = cfg.max_steps
    runs = {name: [] for name in variants}
    for i, name in enumerate(order):
        out = os.path.join(tmp, f"{name}-{i}")
        opts = {k: (os.path.join(out, v) if k == "profile_dir" else v)
                for k, v in variants[name].items()}
        reset_counters()
        t0 = time.perf_counter()
        summary = simulate(cfg, SimOptions(out_dir=out, verbose=False, **opts), device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counters()
        if summary.backend != "cuda-pull" or summary.steps != cfg.max_steps or counts != want:
            raise AssertionError(f"in-process {name}: {summary.backend}, {summary.steps} steps, "
                                 f"launches {counts}, expected {want}")
        add_counts(total, counts)
        runs[name].append((summary, out, wall))
    print(f"  in-process simulate {cfg.nx}^2 Re={cfg.reynolds:g} in turns, MLUPS (elapsed s, "
          f"wall s of the call): " + "; ".join(
              f"{name} " + ", ".join(f"{s.mlups:.1f} ({s.elapsed_s:.4f}, {w:.4f})"
                                     for s, _, w in r)
              for name, r in runs.items()), flush=True)
    return runs, total


def run_command_line(ds, device, tmp: str) -> dict:
    """(m): ``run`` and ``datagen`` as commands, held to the in-process
    runs; returns the launch counts of the in-process ``simulate`` runs."""
    total = {name: 0 for name in COUNTERS}
    # run: the benchmark's cavity with VTK, checkpoints and the first chunk profiled
    out, prof = os.path.join(tmp, "run"), os.path.join(tmp, "run", "profile")
    lines, wall = run_cli(["run", "--nx", str(BENCH_N), "--re", "5000", "--collision", "mrt",
                           "--max-steps", str(CLI_STEPS), "--interval", str(CLI_INTERVAL),
                           "--vtk", "--checkpoint-every", str(CLI_INTERVAL),
                           "--profile", prof, "--out", out])
    summary = json.loads(lines[-1])
    trace = read_trace(os.path.join(prof, "trace.json"), CLI_INTERVAL)
    print(f"  run {BENCH_N}^2 MRT Re=5000, {CLI_STEPS} steps, --vtk, checkpoints, first chunk "
          f"profiled: routed to {summary['backend']}, {summary['steps']} steps, "
          f"{summary['mlups']:.1f} MLUPS, command wall {wall:.2f} s; trace: {trace}",
          flush=True)
    if summary["backend"] != "cuda-pull" or summary["steps"] != CLI_STEPS:
        raise AssertionError(f"run: {summary}")
    cfg = cli_config(BENCH_N, 5000.0)
    outputs = dict(save_vtk=True, checkpoint_every=CLI_INTERVAL)
    variants = {"none": {}, "vtk": dict(save_vtk=True), "command": outputs,
                "command+profile": dict(outputs, profile_dir="profile")}
    runs, counts = simulate_in_turns(cfg, device, tmp, variants,
                                     ["none", "vtk", "command", "command+profile",
                                      "command+profile", "command", "vtk", "none"])
    add_counts(total, counts)
    vtr = [f"ldc.{i}.vtr" for i in range(CLI_STEPS // CLI_INTERVAL)]
    ref = runs["command"][0][1]
    for name in vtr:
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"run's {name} differs from the in-process simulate's")
    print(f"  run's {vtr} equal byte for byte to the in-process simulate's", flush=True)
    for _, run_out, _ in runs["command+profile"]:
        read_trace(os.path.join(run_out, "profile", "trace.json"), CLI_INTERVAL)

    # the same at 128^2, Re=100: the host's share
    plots = importlib.util.find_spec("matplotlib") is not None
    small = os.path.join(tmp, "small")
    lines, wall = run_cli(["run", "--nx", str(CLI_SMALL_N), "--re", "100", "--collision", "mrt",
                           "--max-steps", str(CLI_STEPS), "--interval", str(CLI_INTERVAL),
                           "--profile", os.path.join(small, "profile"), "--out", small]
                          + (["--plots"] if plots else []))
    summary = json.loads(lines[-1])
    trace = read_trace(os.path.join(small, "profile", "trace.json"), CLI_INTERVAL)
    print(f"  run {CLI_SMALL_N}^2 MRT Re=100, first chunk profiled: routed to "
          f"{summary['backend']}, {summary['steps']} steps, {summary['mlups']:.1f} MLUPS, "
          f"command wall {wall:.2f} s; trace: {trace}", flush=True)
    if summary["backend"] != "cuda-pull" or summary["steps"] != CLI_STEPS:
        raise AssertionError(f"run at {CLI_SMALL_N}^2: {summary}")
    if plots and not any(f.endswith(".png") for f in os.listdir(small)):
        raise AssertionError("run --plots wrote no dashboard")
    _, counts = simulate_in_turns(cli_config(CLI_SMALL_N, 100.0), device, tmp,
                                  {"none": {}, "profile": dict(profile_dir="profile")},
                                  ["none", "profile", "profile", "none"])
    add_counts(total, counts)

    # datagen: (h)'s cavities as a command
    data = os.path.join(tmp, "data")
    _, wall = run_cli(["datagen", "--grid", str(SWEEP_N), "--batch", str(SWEEP_CAV),
                       "--re-start", f"{DATAGEN_RE[0]:g}",
                       "--re-stop", f"{DATAGEN_RE[-1] + 10:g}", "--re-step", "10",
                       "--max-steps", str(DATAGEN_MAX_STEPS),
                       "--interval", str(DATAGEN_INTERVAL), "--out", data])
    files = {"Re_range.npy": ds.re_range, "feq_initial.npy": ds.feq_initial,
             "f_final.npy": ds.f_final, "u_final.npy": ds.u_final}
    if sorted(os.listdir(data)) != sorted(files):
        raise AssertionError(f"datagen wrote {sorted(os.listdir(data))}")
    for name, want in files.items():
        got = np.load(os.path.join(data, name))
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"datagen's {name} differs from (h)'s generate_dataset")
    print(f"  datagen {len(DATAGEN_RE)} Re at {SWEEP_N}^2, batch {SWEEP_CAV}: command wall "
          f"{wall:.2f} s; its {sorted(files)} equal (h)'s arrays bit for bit", flush=True)
    if not plots:
        print("  not driven on the card: run --plots, train and predict: they draw with "
              "matplotlib (viz.dashboard, train.plot_history, predict.comparison_figure), "
              "which this machine does not have; they are host code, held to the JAX "
              "package on the CPU by tests/test_torch_cli.py and tests/test_torch_viz.py",
              flush=True)
    return total


def tensors(x) -> list:
    """The tensors of a state, a ``ShardedState`` or a tuple of arguments,
    in order (numbers, arrays and absent blocks left out)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in tensors(item)]
    return []


def max_diff(a, b) -> float:
    """max |a - b| over the tensors of two states (inf if they differ in
    number or shape)."""
    a, b = tensors(a), tensors(b)
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        return math.inf
    return max(((x - y).abs().max().item() for x, y in zip(a, b) if x.numel()), default=0.0)


def graph_vs_eager(name: str, graphed, eager, args: tuple, rows_out: int = 0) -> dict:
    """(n) A graphed runner, built and not yet called, against its eager
    form on ``args`` (which must stay finite): max |d| = 0; the inputs
    untouched; every counter of
    the graphed calls at the eager call's counts (``rows_out``: the copies
    of the lid densities out of the rows a graphed sharded runner keeps,
    beyond the eager runner's copies); and a second call equal too, leaving
    the first call's state unchanged.  Returns the wall seconds of the
    eager call and of the graphed runner's first (which captures) and
    second calls."""
    keys = graphs._counters()
    kept = [t.clone() for t in tensors(args)]

    def counted(fn):
        torch.cuda.synchronize()
        before = [getattr(*key) for key in keys]
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, [getattr(*key) - b for key, b in zip(keys, before)], time.perf_counter() - t0

    want, counts, eager_s = counted(lambda: eager(*args))
    if not all(bool(torch.isfinite(t).all()) for t in tensors(want)):
        raise AssertionError(f"{name}: the eager run left non-finite values")
    want_counts = counts[:-1] + [counts[-1] + rows_out]
    got, first_counts, first_s = counted(lambda: graphed(*args))
    first = [t.clone() for t in tensors(got)]
    again, again_counts, second_s = counted(lambda: graphed(*args))
    err = max(max_diff(got, want), max_diff(again, want))
    untouched = max_diff(args, kept) == 0.0
    survives = max_diff(got, first) == 0.0
    counted_right = first_counts == want_counts == again_counts
    print(f"  {name}: graphed vs eager max|d| {err}, input untouched {untouched}, returned "
          f"state kept over a second call {survives}, counters {first_counts} and "
          f"{again_counts} (eager {want_counts}) equal {counted_right}; wall s eager "
          f"{eager_s:.4f}, graphed first (capture) {first_s:.4f}, second {second_s:.4f}",
          flush=True)
    if err != 0.0 or not (untouched and survives and counted_right):
        raise AssertionError(f"{name}: the graphed runner is not its eager form")
    return {"eager_s": eager_s, "first_s": first_s, "second_s": second_s}


def graph_config(n: int, base: SimConfig) -> SimConfig:
    """``base`` (MRT) at n^2: the Ghia cavity's Re=100 at the small sizes,
    whose runs here reach thousands of steps, the benchmark's Re=5000 at
    the large ones."""
    return dataclasses.replace(base, nx=n, ny=n, reynolds=100.0 if n <= 256 else 5000.0)


def check_graphs(device, sweep_cfg: SimConfig, sharded_cfg: SimConfig) -> dict:
    """(n) Every graphed runner against its eager form (``graph_vs_eager``):
    ``pull`` (MRT, SRT + Smagorinsky + Van Driest, the tangential lid) at
    128^2 over ``GRAPH_STEPS``; the sweep at 32 x 384^2, its omegas changed
    between calls; ``tblock`` over a count of steps that K does not divide;
    ``push`` with each of its walls; both sharded runners (the temporal-block one under both
    transports) on the 2x2 mesh of the card at 128^2 and 4096^2.  Returns
    the capture's seconds per runner: the first call's wall time less the
    second's, for the longest case of each."""
    capture = {}

    def held(label, t):
        capture[label] = t["first_s"] - t["second_s"]

    for name, kw in (("mrt", dict(collision="mrt", reynolds=400.0)),
                     ("srt+smagorinsky+van_driest", dict(
                         collision="srt", reynolds=1000.0, turbulence="smagorinsky",
                         van_driest=True)),
                     ("tangential mrt", dict(collision="mrt", reynolds=400.0,
                                             boundary="nebb_tangential"))):
        cfg = SimConfig(nx=128, ny=128, **kw)
        s0 = noisy_state(cfg, device)
        for n in GRAPH_STEPS:
            t = graph_vs_eager(f"pull {name} 128^2, {n} steps",
                               pull.make_scan_runner(cfg, n, device),
                               pull._eager_scan_runner(cfg, n, device), (s0,))
        held(f"cuda-pull {name} 128^2, {GRAPH_STEPS[-1]} steps", t)
    s_sweep, omegas = sweep_start(sweep_cfg, SWEEP_CAV, device, seed=1)
    graphed = pull.make_sweep_runner(sweep_cfg, SWEEP_CAV, GRAPH_SWEEP_STEPS, device)
    eager = pull._eager_sweep_runner(sweep_cfg, SWEEP_CAV, GRAPH_SWEEP_STEPS, device)
    for label, om in (("omegas", omegas), ("other omegas", omegas[::-1].copy()),
                      ("the first omegas again", omegas)):
        t = graph_vs_eager(f"sweep {SWEEP_CAV} x {SWEEP_N}^2, {GRAPH_SWEEP_STEPS} steps, "
                           f"{label}", graphed, eager, (s_sweep, om))
        if label == "omegas":
            held(f"sweep {SWEEP_CAV} x {SWEEP_N}^2, {GRAPH_SWEEP_STEPS} steps", t)
    del s_sweep, graphed, eager
    one_card = dataclasses.replace(sharded_cfg, mesh_shape=(1, 1))
    for n, steps in GRAPH_TBLOCK_STEPS.items():
        cfg = graph_config(n, one_card)
        t = graph_vs_eager(f"tblock K={tblock.K_STEPS} {n}^2, {steps} steps",
                           tblock.make_scan_runner(cfg, steps, device),
                           tblock._eager_scan_runner(cfg, steps, device),
                           (noisy_state(cfg, device),))
        held(f"cuda-tblock {n}^2, {steps} steps", t)
    for n, counts in GRAPH_PUSH_STEPS.items():
        for wall in PUSH_KERNELS:
            cfg = dataclasses.replace(graph_config(n, one_card), boundary=wall)
            f0 = noisy_state(cfg, device).f
            for steps in counts:
                t = graph_vs_eager(f"push {wall} {n}^2, {steps} steps",
                                   push.make_push_scan_runner(cfg, steps, device),
                                   push._eager_push_scan_runner(cfg, steps, device), (f0,))
            held(f"cuda-push {wall} {n}^2, {steps} steps", t)
    for n, steps in GRAPH_SHARDED_STEPS.items():
        cfg = graph_config(n, sharded_cfg)
        mesh = sharded_mesh(device)
        s0 = shard_state(noisy_state(cfg, device), mesh)
        shards = SHARDED_MESH[0] * SHARDED_MESH[1]
        t = graph_vs_eager(f"cuda-sharded {n}^2 mesh {SHARDED_MESH}, {steps} steps",
                           pull_sharded.make_sharded_runner(cfg, steps, mesh),
                           pull_sharded._eager_sharded_runner(cfg, steps, mesh), (s0,),
                           rows_out=shards)
        held(f"cuda-sharded {n}^2, {steps} steps", t)
        for impl in tblock_sharded.HALO_IMPLS:
            t = graph_vs_eager(
                f"cuda-sharded-tblock {impl} {n}^2 mesh {SHARDED_MESH}, {steps} steps",
                tblock_sharded.make_sharded_runner(cfg, steps, mesh, halo_impl=impl),
                tblock_sharded._eager_sharded_runner(cfg, steps, mesh, halo_impl=impl),
                (s0,), rows_out=shards if steps % tblock_sharded.K_STEPS else 0)
            held(f"cuda-sharded-tblock {impl} {n}^2, {steps} steps", t)
        del s0
    print(f"  capture s per runner (first call less the second): {capture}", flush=True)
    return capture


@contextlib.contextmanager
def eager_runners():
    """Inside the block ``simulate`` (and every caller of the runner
    factories) takes the runners' eager forms, their steps launched one by
    one from the host: the yardstick of the graphs' timings."""
    swaps = [(pull, "make_scan_runner", pull._eager_scan_runner),
             (pull, "make_sweep_runner", pull._eager_sweep_runner),
             (tblock, "make_scan_runner", tblock._eager_scan_runner),
             (push, "make_push_scan_runner", push._eager_push_scan_runner),
             (pull_sharded, "make_sharded_runner", pull_sharded._eager_sharded_runner),
             (tblock_sharded, "make_sharded_runner", tblock_sharded._eager_sharded_runner)]
    saved = [(module, attr, getattr(module, attr)) for module, attr, _ in swaps]
    try:
        for module, attr, eager in swaps:
            setattr(module, attr, eager)
        yield
    finally:
        for module, attr, made in saved:
            setattr(module, attr, made)


def time_graphs(device, sharded_cfg: SimConfig, tmp: str) -> dict:
    """(o) Graph against eager form in turns (graph, eager, eager, graph),
    per step end to end on an idle queue: ``cuda-pull`` and ``cuda-tblock``
    in calls of ``SMALL_CALL_STEPS`` steps at ``GRAPH_TIMING_N``; both
    sharded runners on the 2x2 mesh at 128^2 and 4096^2; a 2 000-step
    ``cuda-pull`` chunk at 128^2 and 1024^2 captured with bodies of
    ``GRAPH_BODIES`` launches (its first call, capture and ms per step);
    and ``simulate``'s MLUPS on the Re=100 128^2 gate
    (``re100_128_nebb_tangential``) and on the 1024^2 Re=5000 main path."""
    out = {}

    def turns(label, runners, state, steps):
        ms = time_runner_pair(runners, state, steps)
        graph, eager = (sum(ms[name]) / 2 for name in ("graph", "eager"))
        out[label] = dict(ms, speed=eager / graph)
        print(f"  {label} in turns: {ms} ms/step; graph/eager speed {eager / graph:.3f}x",
              flush=True)

    for n in GRAPH_TIMING_N:
        cfg = graph_config(n, dataclasses.replace(sharded_cfg, mesh_shape=(1, 1)))
        s0 = noisy_state(cfg, device)
        for route, module in (("cuda-pull", pull), ("cuda-tblock", tblock)):
            turns(f"{route} {n}^2, {SMALL_CALL_STEPS}-step calls", {
                "graph": module.make_scan_runner(cfg, SMALL_CALL_STEPS, device),
                "eager": module._eager_scan_runner(cfg, SMALL_CALL_STEPS, device)},
                s0, SMALL_CALL_STEPS)
        del s0
    mesh = sharded_mesh(device)
    for n, steps in GRAPH_SHARDED_CALL_STEPS.items():
        cfg = graph_config(n, sharded_cfg)
        s0 = shard_state(noisy_state(cfg, device), mesh)
        impl = sim.SHARDED_TBLOCK_HALO_IMPL
        turns(f"cuda-sharded {n}^2 mesh {SHARDED_MESH}, {steps}-step calls", {
            "graph": pull_sharded.make_sharded_runner(cfg, steps, mesh),
            "eager": pull_sharded._eager_sharded_runner(cfg, steps, mesh)}, s0, steps)
        turns(f"cuda-sharded-tblock {impl} {n}^2 mesh {SHARDED_MESH}, {steps}-step calls", {
            "graph": tblock_sharded.make_sharded_runner(cfg, steps, mesh, halo_impl=impl),
            "eager": tblock_sharded._eager_sharded_runner(cfg, steps, mesh, halo_impl=impl)},
            s0, steps)
        del s0
    # the capture's cost against the body's size (graphs.MAX_BODY set for
    # the probe alone): a 2 000-step cuda-pull chunk at 128^2 and 1024^2
    one_card = dataclasses.replace(sharded_cfg, mesh_shape=(1, 1))
    for n in (128, BENCH_N):
        cfg = graph_config(n, one_card)
        s0 = noisy_state(cfg, device)
        found = {}
        for body in GRAPH_BODIES:
            saved, graphs.MAX_BODY = graphs.MAX_BODY, body
            try:
                run = pull.make_scan_runner(cfg, SMALL_CALL_STEPS, device)
                walls = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(s0)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                ms = cuda_time_ms(lambda: run(s0), 3) / SMALL_CALL_STEPS
            finally:
                graphs.MAX_BODY = saved
            found[body] = dict(first_s=walls[0], capture_s=walls[0] - walls[1], ms=ms)
        out[f"capture by body {n}^2"] = found
        print(f"  cuda-pull {n}^2, {SMALL_CALL_STEPS}-step chunk by the graph's body in "
              f"launches: " + "; ".join(
                  f"{body}: first call {v['first_s']:.4f} s, capture {v['capture_s']:.4f} s, "
                  f"{v['ms']:.5f} ms/step" for body, v in found.items()), flush=True)
        del s0, run
    gate = SimConfig(nx=128, ny=128, reynolds=100.0, collision="srt",
                     boundary="nebb_tangential", max_steps=TANG_GATE_STEPS,
                     report_interval=10_000)
    main = SimConfig(nx=BENCH_N, ny=BENCH_N, reynolds=5000.0, collision="mrt",
                     precision="float32", max_steps=10_000, report_interval=5_000)
    for label, cfg in (("re100_128_nebb_tangential", gate), (f"{BENCH_N}^2 Re=5000", main)):
        mlups = {"graph": [], "eager": []}
        for form in ("graph", "eager", "eager", "graph"):
            with eager_runners() if form == "eager" else contextlib.nullcontext():
                summary = simulate(cfg, SimOptions(out_dir=tmp, verbose=False), device=device)
            if summary.backend != "cuda-pull":
                raise AssertionError(f"{label}: routed to {summary.backend}")
            mlups[form].append(summary.mlups)
        graph, eager = (sum(mlups[name]) / 2 for name in ("graph", "eager"))
        out[f"simulate {label}"] = dict(mlups, speed=graph / eager)
        print(f"  simulate {label} MLUPS in turns: {mlups}; graph/eager {graph / eager:.3f}x",
              flush=True)
    return out


def bound(cells: int, nx: int, k_steps: int = 1) -> tuple[float, str]:
    """Least ms per step for the work of one fused step, at the published
    peaks: the 9 planes read once and written once (plus the lid densities)
    per launch of ``k_steps`` steps, or the operations of one step."""
    bytes_ms = (BYTES_PER_CELL * cells + 2 * 4 * nx) / k_steps / PEAK_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_CELL_MRT * cells / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
              f"device: {kind}; nvidia-smi: {smi}", flush=True)

    with phase("build"):
        t0 = time.perf_counter()
        path, log = _build.ensure_built()
        if log is None:
            print(f"  cached: {path.name}", flush=True)
        else:
            print(f"  nvcc built {path.name} in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            for line in log.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}", flush=True)
        _build.load_library()

    worst = {name: 0.0 for name in REPLACES}
    with phase("kernel vs plain"):
        small = [
            ("srt", dict(collision="srt", reynolds=400.0)),
            ("trt", dict(collision="trt", reynolds=400.0)),
            ("mrt", dict(collision="mrt", reynolds=400.0)),
            ("mrt+smagorinsky", dict(collision="mrt", reynolds=5000.0,
                                     turbulence="smagorinsky")),
        ]
        vd = ("srt+smagorinsky+van_driest", dict(collision="srt", reynolds=5000.0,
                                                 turbulence="smagorinsky",
                                                 van_driest=True))
        for name, kw in small + [vd]:
            worst["pull_step"] = max(worst["pull_step"], compare_case(
                name, SimConfig(nx=128, ny=128, **kw), device))
        bench_cfg = SimConfig(nx=BENCH_N, ny=BENCH_N, reynolds=5000.0,
                              collision="mrt", precision="float32").validate()
        large_cfg = dataclasses.replace(bench_cfg, nx=LARGE_N, ny=LARGE_N)
        worst["pull_step"] = max(worst["pull_step"],
                                 compare_case("mrt", bench_cfg, device))
        # the shape the checkpoint-and-resume path (l) gives the kernel
        worst["pull_step"] = max(worst["pull_step"],
                                 compare_case("mrt re=1000", ckpt_config(), device))
        # the tangential entry against the plain tangential engine
        tang = dict(boundary="nebb_tangential")
        for name, kw in small + [vd]:
            worst["pull_step_tangential"] = max(
                worst["pull_step_tangential"],
                compare_case(f"tangential {name}", SimConfig(nx=128, ny=128, **kw, **tang),
                             device))
        tang_bench_cfg = dataclasses.replace(bench_cfg, **tang)
        worst["pull_step_tangential"] = max(
            worst["pull_step_tangential"],
            compare_case("tangential mrt", tang_bench_cfg, device))
        # the shape the BC-closure control of the main path gives the entry
        worst["pull_step_tangential"] = max(
            worst["pull_step_tangential"],
            compare_case("tangential mrt re=1000", tang_control_config(), device))
        check_runner_ping_pong(device)
        for name, kw in small:
            worst["tblock_step"] = max(worst["tblock_step"], compare_tblock(
                name, SimConfig(nx=128, ny=128, **kw), device))
        worst["tblock_step"] = max(worst["tblock_step"],
                                   compare_tblock("mrt", large_cfg, device))
        # bit for bit against the one-step kernel at the sizes the main path
        # runs it (the large cavity, 4096^2 and the Re=100 Ghia run's 128^2)
        for cfg in (large_cfg, dataclasses.replace(bench_cfg, nx=4096, ny=4096),
                    SimConfig(nx=128, ny=128, reynolds=100.0, collision="mrt")):
            worst["tblock_step"] = max(worst["tblock_step"],
                                       compare_tblock_pull(cfg, device, 64))
        # each wall of the push kernel, bit for bit, at 128^2, at the 48^2
        # of the main path's runs (the new walls) and at 1024^2
        for wall, key in PUSH_KERNELS.items():
            cases = [(name, SimConfig(nx=128, ny=128, boundary=wall, **kw))
                     for name, kw in small]
            cases.append(("mrt", dataclasses.replace(bench_cfg, boundary=wall)))
            if wall != "nebb":
                cases.append(("srt re=100", push_run_config(wall)))
            for name, cfg in cases:
                worst[key] = max(worst[key], compare_push(name, cfg, device))

    with phase("kernel vs plain: sharded"):
        n = SHARDED_COMPARE_N
        for name, kw in small + [vd]:
            cfg = SimConfig(nx=n, ny=n, mesh_shape=SHARDED_MESH, **kw)
            worst["pull_sharded_step"] = max(worst["pull_sharded_step"],
                                             compare_sharded(name, cfg, device, pull_sharded))
            if name != vd[0]:
                worst["tblock_sharded_step"] = max(
                    worst["tblock_sharded_step"],
                    compare_sharded(name, cfg, device, tblock_sharded))
        sharded_cfg = dataclasses.replace(bench_cfg, nx=SHARDED_N, ny=SHARDED_N,
                                          mesh_shape=SHARDED_MESH)
        sharded_ghia = SimConfig(nx=128, ny=128, reynolds=100.0, collision="mrt",
                                 max_steps=16_000, report_interval=2_000,
                                 mesh_shape=SHARDED_MESH)
        # both kernels at the shapes the main path gives them
        for name, cfg in (("mrt", sharded_cfg), ("mrt re=100", sharded_ghia)):
            for module in (pull_sharded, tblock_sharded):
                key = module.__name__.rsplit(".", 1)[1] + "_step"
                worst[key] = max(worst[key], compare_sharded(name, cfg, device, module))
        for shape in (SHARDED_MESH, (1, 4)):
            compare_sharded_pull(dataclasses.replace(sharded_cfg, mesh_shape=shape),
                                 device, 64)
        for shape in RDMA_MESHES:
            worst["tblock_sharded_step"] = max(
                worst["tblock_sharded_step"], compare_tblock_sharded_pull(
                    dataclasses.replace(sharded_cfg, mesh_shape=shape), device, 64))

    with phase("kernel vs plain: halo exchange"):
        # at the shapes the main paths give the kernel: the temporal-block
        # runner's tight K=5 carries with panels at 4096^2 (2x2, 4x1) and the
        # Re=100 Ghia run's 128^2; the one-step runner's aligned depth-1
        # carries at 4096^2, 128^2 and the resume path's 256^2; and the
        # x-only table of the JAX contract
        k = tblock_sharded.K_STEPS
        errs = []
        for shape, n, depth, layout in [(s, SHARDED_N, k, "tight") for s in RDMA_MESHES] + [
                (SHARDED_MESH, sharded_ghia.nx, k, "tight"),
                (SHARDED_MESH, SHARDED_N, 1, "aligned"),
                (SHARDED_MESH, sharded_ghia.nx, 1, "aligned"),
                (SHARDED_MESH, CKPT_N, 1, "aligned")]:
            errs.append(compare_refresh(device, shape, n, depth, layout))
        for shape, n in [(s, SHARDED_N) for s in RDMA_MESHES] + [
                (SHARDED_MESH, sharded_ghia.nx)]:
            errs.append(compare_refresh(device, shape, n, k, "tight", x_only=True))
        for cfg in [dataclasses.replace(sharded_cfg, mesh_shape=s) for s in RDMA_MESHES] + [
                sharded_ghia]:
            for n in RDMA_COMPARE_STEPS:
                errs.append(compare_rdma_runner(cfg, device, n))
        for cfg in (sharded_cfg, sharded_ghia):
            errs.append(compare_pull_copies(cfg, device, RDMA_COMPARE_STEPS[1]))
        worst["halo_exchange"] = max(errs)

    with phase("kernel vs plain: sweep form"):
        sweep_cfg = sweep_config()
        # the stacks of the datagen path (h) and of its mesh form (k)
        errs = [compare_sweep("srt+smagorinsky", sweep_cfg, n_cav, device, seed)
                for n_cav in (SWEEP_CAV, len(MESH_RE) // 2) for seed in (None, 1)]
        for name in ("trt", "mrt"):
            errs.append(compare_sweep(name, sweep_config(SWEEP_SMALL_N, collision=name,
                                                         turbulence="none"),
                                      SWEEP_SMALL_CAV, device, 2))
        compare_sweep_singles(sweep_cfg, device)
        check_sweep_nan(sweep_cfg, device)
        worst["pull_sweep_step"] = max(errs)

    with phase("graphs: each graphed runner against its eager form"):
        check_graphs(device, sweep_cfg, sharded_cfg)

    main_launches = {name: 0 for name in REPLACES}
    with phase("main path: cuda-pull"), tempfile.TemporaryDirectory() as tmp:
        main_cfg = dataclasses.replace(bench_cfg, max_steps=10_000,
                                       report_interval=5_000)
        add_counts(main_launches, run_main_path(main_cfg, device, tmp, "auto",
                                                "cuda-pull"))
        add_counts(main_launches, run_converge_path(
            dataclasses.replace(main_cfg, max_steps=5_000), device))
        add_counts(main_launches, run_main_path(
            SimConfig(nx=96, ny=96, reynolds=100.0, collision="mrt",
                      max_steps=12_000, report_interval=2_000),
            device, tmp, "auto", "cuda-pull",
            {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)}))
        add_counts(main_launches, run_main_path(
            SimConfig(nx=96, ny=96, reynolds=400.0, collision="mrt",
                      max_steps=30_000, report_interval=5_000),
            device, tmp, "auto", "cuda-pull",
            {"r2_ux": (">", 0.995), "r2_uy": (">", 0.995),
             "l2_combined": ("<", 0.035)}))

    with phase("main path: tangential lid"), tempfile.TemporaryDirectory() as tmp:
        # the slow gate re100_128_nebb_tangential, then the BC-closure
        # control re1000_512_tang at full size, both through auto
        add_counts(main_launches, run_main_path(
            SimConfig(nx=128, ny=128, reynolds=100.0, collision="srt",
                      boundary="nebb_tangential", max_steps=TANG_GATE_STEPS,
                      report_interval=10_000),
            device, tmp, "auto", "cuda-pull",
            {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)}))
        t0 = time.perf_counter()
        control_mlups = []
        add_counts(main_launches, run_main_path(
            tang_control_config(), device, tmp, "auto", "cuda-pull",
            {"r2_ux": (">=", 0.9993), "l2_combined": ("<=", 0.021)}, control_mlups))
        print(f"  re1000_512_tang: {TANG_CONTROL_STEPS} steps in "
              f"{time.perf_counter() - t0:.2f} s wall, {control_mlups[0]:.1f} MLUPS",
              flush=True)

    # the slow gates before the phases that start process groups, profilers
    # and training, so that the gates' wall times are read on a quiet host
    with phase("main path: the slow gates"), tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, run_slow_gates(device, tmp))

    with phase("main path: large cavity"), tempfile.TemporaryDirectory() as tmp:
        large_run = dataclasses.replace(large_cfg, max_steps=8_000,
                                        report_interval=2_000)
        counts = run_main_path(large_run, device, tmp, "auto", None)
        add_counts(main_launches, counts)
        if counts["tblock_step"] == 0:
            add_counts(main_launches, run_main_path(large_run, device, tmp,
                                                    "cuda-tblock", "cuda-tblock"))
        add_counts(main_launches, run_main_path(
            SimConfig(nx=128, ny=128, reynolds=100.0, collision="mrt",
                      max_steps=16_000, report_interval=2_000),
            device, tmp, "cuda-tblock", "cuda-tblock",
            {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)}))

    with phase("main path: push scheme"), tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, run_main_path(
            SimConfig(nx=96, ny=96, reynolds=100.0, collision="mrt",
                      max_steps=12_000, report_interval=2_000),
            device, tmp, "cuda-push", "cuda-push",
            {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)}))
        # the walls only the push engines implement: auto takes the kernel
        for wall in ("bounce_back", "nebb_west_eq"):
            add_counts(main_launches, run_main_path(
                push_run_config(wall), device, tmp, "auto", "cuda-push"))
    with phase("main path: sharded cavity"), tempfile.TemporaryDirectory() as tmp:
        mesh_devices = [device] * (SHARDED_MESH[0] * SHARDED_MESH[1])
        sharded_run = dataclasses.replace(sharded_cfg, max_steps=2_000,
                                          report_interval=500)
        # auto, the sharded kernel auto did not take, and auto's route with
        # the other transport of the temporal-block runner's refresh
        # (sim.SHARDED_TBLOCK_HALO_IMPL set to the other for the run), in
        # turns forwards and backwards (the first run of a size is slower)
        routed_impl = sim.SHARDED_TBLOCK_HALO_IMPL
        other_impl = {"rdma": "ppermute", "ppermute": "rdma"}[routed_impl]
        counts = run_main_path(sharded_run, mesh_devices, tmp, "auto", None)
        add_counts(main_launches, counts)
        auto_name = ("cuda-sharded-tblock" if counts["tblock_sharded_step"]
                     else "cuda-sharded")
        other = {"cuda-sharded": "cuda-sharded-tblock",
                 "cuda-sharded-tblock": "cuda-sharded"}[auto_name]
        runs = [("auto", "auto", routed_impl), (other, other, routed_impl),
                ("cuda-sharded-tblock " + other_impl, "cuda-sharded-tblock", other_impl)]
        sharded_mlups = {label: [] for label, _, _ in runs}
        for label, backend, impl in runs + runs[::-1]:
            sim.SHARDED_TBLOCK_HALO_IMPL = impl
            try:
                add_counts(main_launches, run_main_path(
                    sharded_run, mesh_devices, tmp, backend,
                    None if backend == "auto" else backend, mlups=sharded_mlups[label]))
            finally:
                sim.SHARDED_TBLOCK_HALO_IMPL = routed_impl
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} simulate MLUPS in turns (auto is "
              f"{auto_name}, halo_impl {routed_impl!r}): {sharded_mlups}", flush=True)
        # the Re=100 Ghia gate at 128^2 on the 2x2 mesh through both runners,
        # the temporal-block one with either transport, in turns
        runs = [("cuda-sharded-tblock " + routed_impl, "cuda-sharded-tblock", routed_impl),
                ("cuda-sharded-tblock " + other_impl, "cuda-sharded-tblock", other_impl),
                ("cuda-sharded", "cuda-sharded", routed_impl)]
        ghia_mlups = {label: [] for label, _, _ in runs}
        for label, backend, impl in runs + runs[::-1]:
            sim.SHARDED_TBLOCK_HALO_IMPL = impl
            try:
                add_counts(main_launches, run_main_path(
                    sharded_ghia, mesh_devices, tmp, backend, backend,
                    {"r2_ux": (">", 0.99), "l2_combined": ("<", 0.05)},
                    mlups=ghia_mlups[label]))
            finally:
                sim.SHARDED_TBLOCK_HALO_IMPL = routed_impl
        print(f"  {sharded_ghia.nx}^2 mesh {SHARDED_MESH} simulate MLUPS in turns: "
              f"{ghia_mlups}", flush=True)

    with phase("main path: rdma runner"):
        # The temporal-block runner with halo_impl="rdma" driven directly, in
        # simulate's 500-step calls: one exchange launch per block, and no
        # halo copy in the loop.
        reset_counters()
        halo.copies = 0
        mesh = sharded_mesh(device)
        interval = sharded_run.report_interval
        runner = tblock_sharded.make_sharded_runner(sharded_cfg, interval, mesh,
                                                    halo_impl="rdma")
        s = shard_state(engine.init_state(sharded_cfg, device), mesh)
        calls = sharded_run.max_steps // interval
        for _ in range(calls):
            s = runner(s)
        torch.cuda.synchronize()
        counts = read_counters()
        shards = SHARDED_MESH[0] * SHARDED_MESH[1]
        blocks = calls * (interval // tblock_sharded.K_STEPS)
        want = {name: 0 for name in COUNTERS}
        want.update(halo_exchange=blocks, tblock_sharded_step=shards * blocks)
        copies_want = calls * sharded_copies(sharded_cfg, interval, "tblock")
        finite = all(bool(torch.isfinite(b).all()) for col in s.f for b in col)
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} rdma runner, {calls} calls of "
              f"{interval} steps: launches={counts} halo copies={halo.copies} "
              f"(expected {copies_want}: per call only) finite={finite}", flush=True)
        if counts != want or halo.copies != copies_want or not finite:
            raise AssertionError(f"rdma runner: launches {counts}, expected {want}; "
                                 f"copies {halo.copies}, expected {copies_want}")
        add_counts(main_launches, counts)
        del s, runner

    with phase("remote form: two processes on the card"):
        remote = run_two_processes()
        print(f"  {IPC_N}^2 mesh {IPC_MESH} across two processes, {IPC_STEPS} steps: "
              f"{json.dumps(remote)}", flush=True)
        for impl in ("rdma", "ppermute"):
            if remote[impl]["max_abs_err"] != 0.0:
                raise AssertionError(f"two processes, {impl}: differs from one process")
        if remote["rdma"]["launches"] == 0 or remote["ppermute"]["sends"] == 0:
            raise AssertionError("the two-process runs did not cross processes")

    with phase("main path: generate_dataset"), tempfile.TemporaryDirectory() as tmp:
        gen_cfg = sweep_config(max_steps=DATAGEN_MAX_STEPS, report_interval=DATAGEN_INTERVAL)
        reason = datagen.sweep_kernel_reason(gen_cfg, device)
        if reason is not None:
            raise AssertionError(f"generate_dataset would not take the sweep kernel: {reason}")
        steps_run = []
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = ml.generate_dataset(gen_cfg, re_values=DATAGEN_RE, batch_size=SWEEP_CAV,
                                 progress=lambda msg: print(f"  {msg}", flush=True),
                                 on_batch=lambda *a: steps_run.append(a[3]), device=device)
        wall_s = time.perf_counter() - t0
        counts = read_counters()
        want = {name: 0 for name in COUNTERS}
        want["pull_sweep_step"] = sum(steps_run)
        cells = SWEEP_CAV * SWEEP_N * SWEEP_N
        print(f"  generate_dataset {len(DATAGEN_RE)} Re {DATAGEN_RE[0]:g}..{DATAGEN_RE[-1]:g} "
              f"at {SWEEP_N}^2 in batches of {SWEEP_CAV}: route cuda-sweep "
              f"(pull.make_sweep_runner), steps per batch {steps_run}, launches={counts}, "
              f"wall {wall_s:.3f} s, {cells * sum(steps_run) * 1e-6 / wall_s:.1f} MLUPS end "
              f"to end", flush=True)
        if counts != want:
            raise AssertionError(f"generate_dataset: launches {counts}, expected {want}")
        n = len(DATAGEN_RE)
        shapes = {"re_range": (n,), "feq_initial": (9, SWEEP_N, SWEEP_N),
                  "f_final": (n, 9, SWEEP_N, SWEEP_N), "u_final": (n, 2, SWEEP_N, SWEEP_N)}
        for name, shape in shapes.items():
            a = getattr(ds, name)
            if a.shape != shape or not np.isfinite(a).all():
                raise AssertionError(f"generate_dataset: {name} {a.shape}, expected a finite "
                                     f"{shape}")
        if ds.failed.any():
            raise AssertionError(f"generate_dataset: cavities failed: {DATAGEN_RE[ds.failed]}")
        ml.save_dataset(ds, tmp)
        back = ml.load_dataset(tmp)
        if not all(np.array_equal(getattr(back, k), getattr(ds, k)) for k in shapes) \
                or back.failed is not None:
            raise AssertionError("save_dataset / load_dataset do not round-trip")
        add_counts(main_launches, counts)
        # a batch of 4 through the plain engine on the card, against the kernel's route
        short = dataclasses.replace(gen_cfg, max_steps=COMPARE_STEPS,
                                    report_interval=COMPARE_STEPS)
        res = DATAGEN_RE[:DATAGEN_PLAIN_BATCH]
        kern = ml.generate_dataset(short, re_values=res, batch_size=DATAGEN_PLAIN_BATCH,
                                   device=device)
        plain = datagen._generate_batches(short, res, DATAGEN_PLAIN_BATCH, None, None, [device],
                                          stacked=False)
        worst["pull_sweep_step"] = max(worst["pull_sweep_step"], *(
            check_close(f"generate_dataset kernel vs plain engine, {name}", short,
                        torch.from_numpy(getattr(kern, name)),
                        torch.from_numpy(getattr(plain, name)))
            for name in ("f_final", "u_final")))

    with phase("main path: serving"):
        preset = models.PRESETS[SERVE_PRESET]
        data = train.prepare_inputs(ds, preset, u_lid=gen_cfg.u_lid)
        fnet, aux = predict.build_input(SERVE_PRESET, SERVE_RE, ds.feq_initial, data.scalers,
                                        u_lid=gen_cfg.u_lid)
        model_x = models.make_model(SERVE_PRESET, seed=0)
        model_y = models.make_model(SERVE_PRESET, seed=1)
        u_card = predict.predict_velocity(SERVE_PRESET, model_x, model_y, fnet, aux,
                                          data.scalers, device=device)
        u_cpu = predict.predict_velocity(SERVE_PRESET, model_x, model_y, fnet, aux,
                                         data.scalers, device="cpu")
        if u_card.shape != (2, SWEEP_N, SWEEP_N) or not np.isfinite(u_card).all():
            raise AssertionError(f"predict_velocity: {u_card.shape}, not a finite "
                                 f"(2, {SWEEP_N}, {SWEEP_N})")
        err = float(np.abs(u_card - u_cpu).max())
        print(f"  {SERVE_PRESET} {SWEEP_N}^2 Re={SERVE_RE:g}: card vs CPU max|du|={err:.3e} "
              f"(max|u| {np.abs(u_cpu).max():.3e}; rtol 1e-4, atol 1e-5, TF32 off)",
              flush=True)
        np.testing.assert_allclose(u_card, u_cpu, rtol=1e-4, atol=1e-5)
        model = model_x.to(device)
        batch = preset.batch_size
        xb = torch.from_numpy(np.repeat(fnet, batch, axis=0)).to(device)
        auxb = torch.from_numpy(np.repeat(aux, batch, axis=0)).to(device)
        serve_ms = {}
        with torch.no_grad():
            for tf32 in (False, True, True, False):
                model.allow_tf32 = tf32
                model(xb, auxb)
                serve_ms.setdefault(f"tf32={tf32}", []).append(
                    cuda_time_ms(lambda: model(xb, auxb), SERVE_REPS))
        model.allow_tf32 = False
        print(f"  {SERVE_PRESET} forward, batch {batch} at {SWEEP_N}^2 in turns: "
              f"{serve_ms} ms", flush=True)
        del model, xb, auxb

    with phase("main path: serving the repo's weights"):
        serve_artifact(ds, device)

    with phase("main path: training"), tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        run_training(ds, gen_cfg.u_lid, device, tmp)
        if any(read_counters().values()):
            raise AssertionError(f"training launched a kernel of the port: {read_counters()}")

    with phase("main path: generate_dataset on a mesh"):
        add_counts(main_launches, run_datagen_mesh(device))

    with phase("main path: the surrogate pipeline's scripts"), \
            tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, run_pipeline_scripts(device, tmp))

    with phase("main path: train_full and the pipeline runner over the cards"), \
            tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, run_train_scripts(device, tmp))

    with phase("the pipeline runner's epoch estimates"):
        time_training_epochs(device)

    with phase("main path: the whole-dataset scripts and the sweep's determinism"), \
            tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, check_sweep_determinism(tmp))
        add_counts(main_launches, run_whole_dataset_scripts(device, tmp))

    with phase("main path: the fidelity probe, the rollup and weak scaling"), \
            tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, run_last_scripts(device, tmp))

    with phase("main path: checkpoint and resume"), tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, run_checkpoint_resume(device, tmp))

    with phase("main path: the command line"), tempfile.TemporaryDirectory() as tmp:
        add_counts(main_launches, run_command_line(ds, device, tmp))

    print(f"  launches on the main paths: {main_launches}", flush=True)
    for name, n in main_launches.items():
        if n == 0:
            raise AssertionError(f"{name} was launched no time on the main paths")

    timing = {}
    with phase("timing"):
        src = torch.empty(2**28, dtype=torch.float32, device=device)  # 1 GiB
        dst = torch.empty_like(src)
        dst.copy_(src)
        copy_ms = cuda_time_ms(lambda: dst.copy_(src), 20)
        copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)
        del src, dst
        print(f"  device copy: {copy_bw / 1e9:.1f} GB/s (1 GiB read + 1 GiB "
              f"written per copy)", flush=True)

        # the benchmark's measurement (bench.measure: a warm-up chunk, then
        # BENCH_CHUNKS chunks between two synchronisations) through the
        # route it takes, its launches counted: the bench's path
        reset_counters()
        res = bench.measure(bench_cfg, "auto", BENCH_CHUNK, BENCH_CHUNKS, device)
        counts = read_counters()
        want = {name: 0 for name in COUNTERS}
        want["pull_step"] = BENCH_CHUNK * (BENCH_CHUNKS + 1)
        if res["route"] != "cuda-pull" or counts != want:
            raise AssertionError(f"the bench ran {res['route']} with launches {counts}, "
                                 f"expected cuda-pull with {want}")
        add_counts(main_launches, counts)
        print(json.dumps(bench.record(bench_cfg, res)), flush=True)
        cells = bench_cfg.nx * bench_cfg.ny
        bound_mlups = copy_bw / BYTES_PER_CELL * 1e-6
        b_ms, b_by = bound(cells, bench_cfg.nx)
        timing["pull_step"] = dict(
            ms=res["ms_per_step"], bound_ms=b_ms, bound_by=b_by,
            plain_ms=time_plain(engine.make_fused_step(bench_cfg),
                                engine.init_state(bench_cfg, device)))
        pull_mlups = cells * 1e-3 / res["ms_per_step"]
        print(f"  pull_step {BENCH_N}^2: {timing['pull_step']['ms']:.5f} ms/step, "
              f"{pull_mlups:.1f} MLUPS by CUDA events ({res['mlups']:.1f} on the wall "
              f"clock, launches {counts['pull_step']}), {pull_mlups / bound_mlups:.3f} of "
              f"the measured 72 B/cell copy bound; plain "
              f"{timing['pull_step']['plain_ms']:.4f} ms/step; bound {b_ms:.5f} "
              f"ms/step by {b_by}", flush=True)

        # the tangential entry beside the NEBB one, in turns, at 1024^2 MRT
        lid_ms = {"nebb": [], "tangential": []}
        lid_cfgs = {"nebb": bench_cfg, "tangential": tang_bench_cfg}
        lid_start = engine.init_state(bench_cfg, device)
        for lid in ("nebb", "tangential", "tangential", "nebb"):
            lid_ms[lid].append(time_runner(
                pull.make_scan_runner(lid_cfgs[lid], SWEEP_STEPS, device), lid_start,
                SWEEP_STEPS))
        tang_ms = sum(lid_ms["tangential"]) / 2
        b_ms, b_by = bound(cells, bench_cfg.nx)
        timing["pull_step_tangential"] = dict(
            ms=tang_ms, bound_ms=b_ms, bound_by=b_by,
            plain_ms=time_plain(engine.make_fused_step(tang_bench_cfg),
                                engine.init_state(tang_bench_cfg, device)))
        print(f"  pull_step_tangential {BENCH_N}^2 in turns with pull_step: {lid_ms} ms/step; "
              f"tangential/nebb time {tang_ms / (sum(lid_ms['nebb']) / 2):.4f}; "
              f"{cells * 1e-3 / tang_ms:.1f} MLUPS, {b_ms / tang_ms:.3f} of the bound "
              f"{b_ms:.5f} ms/step by {b_by}; plain tangential engine "
              f"{timing['pull_step_tangential']['plain_ms']:.4f} ms/step", flush=True)

        for n in (BENCH_N, LARGE_N):
            cfg = dataclasses.replace(bench_cfg, nx=n, ny=n)
            cells = n * n
            s0 = engine.init_state(cfg, device)
            pull_ms = time_runner(pull.make_scan_runner(cfg, SWEEP_STEPS, device),
                                  s0, SWEEP_STEPS)
            plain_ms = time_plain(engine.make_fused_step(cfg), s0)
            print(f"  {n}^2 pull_step {pull_ms:.5f} ms/step "
                  f"({cells * 1e-3 / pull_ms:.1f} MLUPS); plain {plain_ms:.4f} "
                  f"ms/step", flush=True)
            for k in SWEEP_K:
                ms = time_runner(tblock.make_scan_runner(cfg, SWEEP_STEPS, device,
                                                         k_steps=k), s0, SWEEP_STEPS)
                b_ms, b_by = bound(cells, n, k)
                print(f"  {n}^2 tblock_step K={k:2d} {ms:.5f} ms/step "
                      f"({cells * 1e-3 / ms:.1f} MLUPS, {pull_ms / ms:.3f}x "
                      f"pull_step); bound {b_ms:.5f} ms/step by {b_by}", flush=True)
                if n == LARGE_N and k == tblock.K_STEPS:
                    timing["tblock_step"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                                                 plain_ms=plain_ms)

        # Where is tblock_step (default K) ahead of pull_step?  Timed in turns
        # (pull, tblock, tblock, pull), from rest and from the state after
        # SWEEP_STEPS steps (a flow at rest has run slower: PERF.md, section
        # 7); it counts as ahead only where both readings put it ahead.
        ahead = []
        for n in AHEAD_N:
            cfg = dataclasses.replace(bench_cfg, nx=n, ny=n)
            runners = {"pull": pull.make_scan_runner(cfg, SWEEP_STEPS, device),
                       "tblock": tblock.make_scan_runner(cfg, SWEEP_STEPS, device)}
            s0 = engine.init_state(cfg, device)
            s1 = runners["pull"](s0)
            runners["tblock"](s1)
            ratios = []
            for label, s in (("rest", s0), ("further on", s1)):
                ms = {"pull": [], "tblock": []}
                for name in ("pull", "tblock", "tblock", "pull"):
                    ms[name].append(cuda_time_ms(lambda: runners[name](s), 1) / SWEEP_STEPS)
                p_ms, t_ms = sum(ms["pull"]) / 2, sum(ms["tblock"]) / 2
                ratios.append(p_ms / t_ms)
                print(f"  {n}^2 in turns from {label}: pull_step {ms['pull']} tblock_step "
                      f"K={tblock.K_STEPS} {ms['tblock']} ms/step; "
                      f"tblock/pull {p_ms / t_ms:.3f}x", flush=True)
            if min(ratios) > AHEAD_MARGIN:
                ahead.append(n)
            del s0, s1, s, runners
        print(f"  tblock_step ahead of pull_step by more than {AHEAD_MARGIN - 1:.1%} "
              f"from rest and further on at {ahead}; sim.py routes auto to it from "
              f"{sim.TBLOCK_AUTO_MIN_CELLS} cells", flush=True)

        cells = BENCH_N * BENCH_N
        f0 = engine.init_state(bench_cfg, device).f
        ms = time_runner(push.make_push_scan_runner(bench_cfg, SWEEP_STEPS, device),
                         f0, SWEEP_STEPS)
        b_ms, b_by = bound(cells, BENCH_N)
        timing["push_step"] = dict(
            ms=ms, bound_ms=b_ms, bound_by=b_by,
            plain_ms=time_plain(engine.make_push_oracle_step(bench_cfg), f0))
        print(f"  {BENCH_N}^2 push_step {ms:.5f} ms/step ({cells * 1e-3 / ms:.1f} "
              f"MLUPS); plain {timing['push_step']['plain_ms']:.4f} ms/step; bound "
              f"{b_ms:.5f} ms/step by {b_by}", flush=True)
        # the push kernel's other two walls, each in turns with its NEBB form
        # (nebb, wall, wall, nebb) at 1024^2 MRT, by CUDA events; the bound
        # is the same 72 B/cell (the walls are O(perimeter))
        for wall in ("nebb_west_eq", "bounce_back"):
            wall_cfg = dataclasses.replace(bench_cfg, boundary=wall)
            runners = {"nebb": push.make_push_scan_runner(bench_cfg, SWEEP_STEPS, device),
                       wall: push.make_push_scan_runner(wall_cfg, SWEEP_STEPS, device)}
            for run in runners.values():
                run(f0)
            ms = {"nebb": [], wall: []}
            for name in ("nebb", wall, wall, "nebb"):
                ms[name].append(cuda_time_ms(lambda: runners[name](f0), 1) / SWEEP_STEPS)
            wall_ms = sum(ms[wall]) / 2
            timing[PUSH_KERNELS[wall]] = dict(
                ms=wall_ms, bound_ms=b_ms, bound_by=b_by,
                plain_ms=time_plain(engine.make_push_oracle_step(wall_cfg), f0))
            print(f"  {BENCH_N}^2 push_step {wall} in turns with nebb: {ms} ms/step; "
                  f"{wall}/nebb time {wall_ms / (sum(ms['nebb']) / 2):.4f}; "
                  f"{cells * 1e-3 / wall_ms:.1f} MLUPS, {b_ms / wall_ms:.3f} of the bound "
                  f"{b_ms:.5f} ms/step by {b_by}; plain (push oracle) "
                  f"{timing[PUSH_KERNELS[wall]]['plain_ms']:.4f} ms/step", flush=True)
            del runners
        del res, lid_start, f0

    with phase("the bench command"):
        run_bench_command(pull_mlups)

    with phase("timing: sweep form"):
        # In turns with pull_step at 1024^2 (pull, sweep, sweep, pull), per
        # cell: the sweep at the datagen cavity with SWEEP_CAV cavities.
        cells = {"pull": BENCH_N * BENCH_N, "sweep": SWEEP_CAV * SWEEP_N * SWEEP_N}
        s_sweep, omegas = sweep_start(sweep_cfg, SWEEP_CAV, device)
        runners = {
            "pull": functools.partial(pull.make_scan_runner(bench_cfg, SWEEP_STEPS, device),
                                      engine.init_state(bench_cfg, device)),
            "sweep": functools.partial(pull.make_sweep_runner(sweep_cfg, SWEEP_CAV,
                                                              SWEEP_STEPS, device),
                                       s_sweep, omegas)}
        for run in runners.values():
            run()
        ms = {"pull": [], "sweep": []}
        for name in ("pull", "sweep", "sweep", "pull"):
            ms[name].append(cuda_time_ms(runners[name], 1) / SWEEP_STEPS)
        bound_mlups = copy_bw / BYTES_PER_CELL * 1e-6
        for name in ("pull", "sweep"):
            t = sum(ms[name]) / 2
            print(f"  {name} {cells[name]} cells: {ms[name]} ms/step, "
                  f"{cells[name] * 1e-3 / t:.1f} MLUPS, {cells[name] * 1e-3 / t / bound_mlups:.3f} "
                  f"of the measured 72 B/cell copy bound", flush=True)
        b_ms, b_by = bound(cells["sweep"], SWEEP_CAV * SWEEP_N)
        plain = engine.make_stacked_step_omega(sweep_cfg, SWEEP_CAV)
        om = torch.tensor(omegas, dtype=torch.float32, device=device)
        timing["pull_sweep_step"] = dict(
            ms=sum(ms["sweep"]) / 2, bound_ms=b_ms, bound_by=b_by,
            plain_ms=time_plain(lambda s: plain(s, om), s_sweep, reps=3))
        print(f"  pull_sweep_step x{SWEEP_CAV} {SWEEP_N}^2: {timing['pull_sweep_step']['ms']:.5f} "
              f"ms/step; bound {b_ms:.5f} ms/step by {b_by} (published), "
              f"{BYTES_PER_CELL * cells['sweep'] / copy_bw * 1e3:.5f} at the measured copy "
              f"rate; plain {timing['pull_sweep_step']['plain_ms']:.4f} ms/step", flush=True)
        # the one-cavity form at 384^2: device time per step with the queue
        # held busy, host time per step
        one = pull.make_scan_runner_omega(sweep_cfg, SMALL_STEPS, device)
        s1 = engine.init_state(sweep_cfg, device)
        busy_ms, host_us = busy_time(lambda: one(s1, omegas[0]), 1)
        end_ms = cuda_time_ms(lambda: one(s1, omegas[0]), 1)
        print(f"  one-cavity form {SWEEP_N}^2: device {busy_ms / SMALL_STEPS:.5f} ms/step, "
              f"host {host_us / SMALL_STEPS:.2f} us/step, end to end "
              f"{end_ms / SMALL_STEPS:.5f} ms/step", flush=True)
        del s_sweep, runners, run

    with phase("timing: sharded"):
        mesh = sharded_mesh(device)
        cells = SHARDED_N * SHARDED_N
        # Both sharded runners from rest in simulate's calls of
        # report_interval steps over the main path's steps (each runner called
        # once before), and the one-step runner's pad and unpad copies (made
        # once per call).
        s0 = shard_state(engine.init_state(sharded_cfg, device), mesh)
        interval = sharded_run.report_interval
        rest_ms = {}
        for name, make in (
                ("cuda-sharded", lambda: pull_sharded.make_sharded_runner(
                    sharded_cfg, interval, mesh)),
                ("cuda-sharded-tblock", lambda: tblock_sharded.make_sharded_runner(
                    sharded_cfg, interval, mesh, halo_impl=sim.SHARDED_TBLOCK_HALO_IMPL)),
                ("cuda-sharded-tblock " + other_impl, lambda: tblock_sharded.make_sharded_runner(
                    sharded_cfg, interval, mesh, halo_impl=other_impl))):
            chunk = make()
            chunk(s0)    # the graph's capture, out of the timing

            def from_rest():
                s = s0
                for _ in range(sharded_run.max_steps // interval):
                    s = chunk(s)

            rest_ms[name] = cuda_time_ms(from_rest, 1) / sharded_run.max_steps
        lay = pull_sharded.layout(SHARDED_N // SHARDED_MESH[0], SHARDED_N // SHARDED_MESH[1])
        pad_ms = cuda_time_ms(lambda: halo.unpad_blocks(halo.pad_blocks(s0.f, lay), lay), 5)
        one = rest_ms["cuda-sharded"]
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} runners from rest in {interval}-step "
              f"calls: {rest_ms} ms/step ({cells * 1e-3 / one:.1f} MLUPS one-step); "
              f"tblock/one-step {one / rest_ms['cuda-sharded-tblock']:.3f}x; pad + unpad "
              f"{pad_ms:.4f} ms per call ({pad_ms / (one * interval):.4f} of a one-step "
              f"call)", flush=True)
        # The rest from the state after SHARDED_WARM_STEPS steps of the
        # one-step kernel.
        warm = pull_sharded.make_sharded_runner(sharded_cfg, SHARDED_STEPS, mesh)
        s1 = s0
        for _ in range(SHARDED_WARM_STEPS // SHARDED_STEPS):
            s1 = warm(s1)
        del s0, chunk, warm
        # pull_step on the same cells and state, launched alone as the
        # sharded kernels are below
        one_cfg = dataclasses.replace(sharded_cfg, mesh_shape=(1, 1))
        g1 = unshard_state(s1, device)
        out = engine.State(torch.empty_like(g1.f), torch.empty_like(g1.rho_lid))
        pull_ms = cuda_time_ms(lambda: pull.pull_step(one_cfg, g1.f, g1.rho_lid, out.f,
                                                      out.rho_lid), SHARDED_STEPS)
        del g1, out
        print(f"  {SHARDED_N}^2 pull_step on the same state, launched alone "
              f"{pull_ms:.5f} ms/step ({cells * 1e-3 / pull_ms:.1f} MLUPS)", flush=True)
        for name, k in (("pull_sharded_step", None),
                        ("tblock_sharded_step", tblock_sharded.K_STEPS)):
            t = time_sharded(sharded_cfg, device, s1, k)
            t["bound_ms"], t["bound_by"] = sharded_bound(sharded_cfg, k or 1)
            timing[name] = t
            print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} {name}"
                  f"{'' if k is None else f' K={k}'}: runner {t['full_ms']:.5f} "
                  f"ms/step ({cells * 1e-3 / t['full_ms']:.1f} MLUPS); kernel launches "
                  f"alone {t['ms']:.5f} ms/step (on one fixed input "
                  f"{t['fixed_ms']:.5f}); halo exchange alone by copies "
                  f"{t['exchange_ms']:.5f} ms/step ({t['exchange_ms'] / t['full_ms']:.3f} "
                  f"of the runner), by the kernel {t['exchange_kernel_ms']:.5f} ms/step "
                  f"device, {t['exchange_kernel_host_us']:.2f} us host per launch; plain {t['plain_ms']:.4f} ms/step; bound "
                  f"{t['bound_ms']:.5f} ms/step by {t['bound_by']}", flush=True)

        # Is the temporal-block runner ahead of the one-step one?  In turns,
        # from the state after SHARDED_WARM_STEPS steps (each runner called
        # once before: its graph's capture out of the turns).
        runners = {
            "cuda-sharded": pull_sharded.make_sharded_runner(sharded_cfg, SHARDED_STEPS, mesh),
            "cuda-sharded-tblock": tblock_sharded.make_sharded_runner(
                sharded_cfg, SHARDED_STEPS, mesh, halo_impl=sim.SHARDED_TBLOCK_HALO_IMPL)}
        for run in runners.values():
            run(s1)
        ms = {name: [] for name in runners}
        for name in ("cuda-sharded", "cuda-sharded-tblock", "cuda-sharded-tblock",
                     "cuda-sharded") * 2:
            ms[name].append(cuda_time_ms(lambda: runners[name](s1), 1) / SHARDED_STEPS)
        one, blk = (sum(ms[n]) / len(ms[n]) for n in runners)
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} in turns: {ms} ms/step; "
              f"tblock/one-step {one / blk:.3f}x; ahead by more than "
              f"{AHEAD_MARGIN - 1:.1%}: {one / blk > AHEAD_MARGIN}; sim.py routes auto "
              f"to it for shards of {sim.SHARDED_TBLOCK_AUTO_MIN_CELLS} cells", flush=True)
        # (d) the halo refresh: the kernel's one launch against its plain
        # version and the same moves by copy_pairs; then both runners against
        # their copy-driven forms, in turns, from the same state
        t = time_exchange(sharded_cfg, device, s1)
        timing["halo_exchange"] = t
        print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} K={tblock_sharded.K_STEPS} whole-halo "
              f"refresh of {t['rects']} rectangles, {t['bytes']} B read + written: "
              f"halo_exchange {t['ms']:.5f} ms device (queue held busy), "
              f"{t['host_us']:.2f} us host per call, {t['idle_ms']:.5f} ms per call on an "
              f"idle queue; plain (phases copied in order) {t['plain_ms']:.5f} ms, the "
              f"same moves by copy_pairs {t['library_ms']:.5f} ms; bound "
              f"{t['bound_ms']:.5f} ms (bytes). x-only table: {t['x_ms']:.5f} ms device, "
              f"{t['x_host_us']:.2f} us host, copy_pairs {t['x_library_ms']:.5f} ms, bound "
              f"{t['x_bound_ms']:.5f} ms; turns (device ms, host us) {t['turns']}",
              flush=True)
        steps = RUNNER_TURN_STEPS
        for label, runners in (
                ("cuda-sharded-tblock", {
                    impl: tblock_sharded.make_sharded_runner(
                        sharded_cfg, steps, mesh, halo_impl=impl)
                    for impl in ("rdma", "ppermute")}),
                ("cuda-sharded", {
                    "kernel": pull_sharded.make_sharded_runner(sharded_cfg, steps, mesh),
                    "copies": copy_driven_pull_runner(sharded_cfg, steps, mesh)})):
            ms = time_runner_pair(runners, s1, steps)
            a, b = runners
            print(f"  {SHARDED_N}^2 mesh {SHARDED_MESH} {label} runner, {steps}-step calls "
                  f"in turns: {ms} ms/step; {a}/{b} speed "
                  f"{sum(ms[b]) / sum(ms[a]):.4f}x", flush=True)
        del s1, runners, run

    with phase("timing: small grids"):
        # Per-step device time (queue held busy) and host time at 96^2-128^2,
        # single-device and on the 2x2 mesh, each runner beside its
        # copy-driven form where it has one; idle share = 1 - device / end
        # to end.
        for n in SMALL_N:
            cfg = SimConfig(nx=n, ny=n, reynolds=100.0, collision="mrt")
            s0 = noisy_state(cfg, device)
            for name, module in (("cuda-pull", pull), ("cuda-tblock", tblock)):
                runner = module.make_scan_runner(cfg, SMALL_STEPS, device)
                busy_ms, host_us = busy_time(lambda: runner(s0), 1)
                end_ms = cuda_time_ms(lambda: runner(s0), 1)
                print(f"  {n}^2 {name}: device {busy_ms / SMALL_STEPS:.5f} ms/step, host "
                      f"{host_us / SMALL_STEPS:.2f} us/step, end to end "
                      f"{end_ms / SMALL_STEPS:.5f} ms/step, idle share "
                      f"{1 - busy_ms / end_ms:.3f}", flush=True)
            cfg = dataclasses.replace(cfg, mesh_shape=SHARDED_MESH)
            mesh = sharded_mesh(device)
            s0 = shard_state(noisy_state(cfg, device), mesh)
            for label, make in (
                    ("cuda-sharded-tblock", lambda steps: {
                        impl: tblock_sharded.make_sharded_runner(cfg, steps, mesh,
                                                                 halo_impl=impl)
                        for impl in ("rdma", "ppermute")}),
                    ("cuda-sharded", lambda steps: {
                        "kernel": pull_sharded.make_sharded_runner(cfg, steps, mesh),
                        "copies": copy_driven_pull_runner(cfg, steps, mesh)})):
                # end to end in simulate's calls at this size; the device's
                # time per step from calls short enough to queue behind the
                # sleep
                end = time_runner_pair(make(SMALL_CALL_STEPS), s0, SMALL_CALL_STEPS)
                busy = busy_step_pair(make, s0, SMALL_SHARDED_STEPS)
                a, b = busy
                idle = {name: 1 - sum(d for d, _ in busy[name]) / sum(end[name])
                        for name in busy}
                print(f"  {n}^2 mesh {SHARDED_MESH} {label} runner in turns: end to end in "
                      f"{SMALL_CALL_STEPS}-step calls {end} ms/step ({a}/{b} speed "
                      f"{sum(end[b]) / sum(end[a]):.3f}x); device ms/step (calls of "
                      f"{2 * SMALL_SHARDED_STEPS} less calls of {SMALL_SHARDED_STEPS} steps) "
                      f"and host us/step {busy}; idle share {idle}", flush=True)

    with phase("timing: graphs against the eager form"), tempfile.TemporaryDirectory() as tmp:
        time_graphs(device, sharded_cfg, tmp)

    check_memory()
    print(f"chip_smoke total wall time: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": main_launches[name],
        "max_abs_err": worst[name],
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name].get("library_ms"),
    } for name in REPLACES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
