#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no environment set:

    python3 chip_smoke.py

It builds every kernel of the port's paths from the sources in the
checkout (one ``nvcc`` per source, all started together), holds each
against its plain PyTorch version on the card, drives the paths —
``run_simulation(..., backend="simx")`` for megha and the oracle at 49,984
workers and 480,000 tasks, the Fig. 2 sweep (``fig2_sweep``'s grid of 3
loads x 2 seeds as one batched program) for megha, pigeon, the oracle,
sparrow and eagle at that size, the Fig. 4 availability grid (``fig4_sweep``'s
4 crash fractions x 2 seeds) for the same five rules at that size, the
streaming engine (``run_steady_state``) for the five rules at 50,000
workers, the sharded executors (``simx/shard.py``: the grids on a mesh and
the lane-batched load curve of every rule), the static analysis and the
quickstart, eagle's
long-job path on the google-like trace at 13,000 workers, the Megha serving engine at 49,984 slots with
200,000 requests, real-decode serving at qwen15_05b's and at
DeepSeek-V2-Lite's full width (with the MoE, MLA, SSM and hybrid families
checked at full width), and the fast path's SDPS loop — and prints one
JSON line per phase:

  build        nvcc time, registers / shared memory / spills per kernel
               (match.cu, match_tasks.cu, p2_sketch.cu)
  kernel       the batched kernel (both designs: wide rows split over blocks,
               narrow rows one warp each) against its plain version over a
               sweep of widths (tile and narrow-threshold edges among them),
               dtypes and n, and at [50000, 64]; then at the main path's
               shapes, the narrow [50000, 64], the sparrow/eagle
               head-of-queue picks (n = 1: [300000, 40], [50000, 40],
               [13000, 64]), eagle's central matches ([1, 13000],
               [6, 50000]), the Fig. 4 grid's shapes at B = 8
               ([64, 49984], [64, 6248], [8, 50000], [10000, 40] and the
               n = 1 pick [400000, 40]) and the 4-lane curve's ([32, 6248],
               [32, 49984], [4, 50000], [5000, 40] and the n = 1 pick
               [200000, 16]): error, time, plain time, torch.cumsum time,
               bytes and the byte bound; then the P² kernel at the curve's
               [4, 193], bitwise its plain version, timed with its bound
  kernel_single  the single-row kernel (both entry points, match_ranks and
               the fused match_tasks) likewise, at the serving and SDPS
               shapes
  megha_plain  kernel and plain-match runs in turns: final states bitwise
               equal, launches = rounds + borrow rounds, walls
  megha_sync   host synchronisations of one run, counted by torch
  megha        the main path through run_simulation: tasks completed,
               rounds, delays, counters, kernel launches, host syncs per
               round, wall, memory (printed after the two phases above,
               which give its rounds and syncs)
  megha_profile  torch.profiler over a steady window: device busy/idle,
               the batched kernel's µs per launch and share of device time
  oracle       the oracle on the same trace, and megha's gap above it
  stream       the streaming engine: (a) megha's and the oracle's replay of
               that trace through a window of its full size (480 jobs,
               480,000 tasks, 64 rounds a refill), sorted delays bitwise
               the fixed runs'; (b) all five rules under open-loop Poisson
               arrivals of 1,000-task jobs at 40 a second (load 0.8 at
               50,000 workers) for 30 simulated seconds through a window
               of 192 jobs / 196,608 tasks, 32 rounds a refill: the ledger
               balanced at every refill, nothing lost, match launches =
               rounds x the rule's matches + megha's borrow rounds, one P²
               launch per refill; wall and its refill / segment split,
               tasks per wall second, admission lag, sketch p50 / p95 /
               p99 / p999, mean utilisation, state bytes, peak memory;
               (c) megha and eagle with the plain versions, bitwise; (d)
               megha to 15 s, the same state bytes; (e) megha's (b) run
               driven segment by segment (held bitwise to it): the P²
               kernel against its plain version after every absorb, both
               timed, and the kernel's walk timed in-kernel (its chain
               bound); (f) segment 5 of that run and of sparrow's, run
               twice from the same inputs, timed and under
               torch.profiler: device busy and idle share a round over
               the segment's own wall, the refill's host time
  sweep        the Fig. 2 grid (loads 0.2 / 0.5 / 0.8 x seeds 0 / 1) for
               megha, pigeon, the oracle, sparrow and eagle as one batched
               run each: every point completes, kernel and plain final
               states bitwise equal, launches per round, grid wall and
               tasks per wall second at B = 6 and at B = 1 (one point,
               bitwise that point of the grid), sparrow's and eagle's queue
               counters; megha's (0.8, seed 0) point against a standalone
               run of the same trace
  sweep_profile  torch.profiler over megha's and sparrow's grids, rounds
               128-192 at B = 6
  fig4         the Fig. 4 grid (crash fractions 0 / 0.05 / 0.1 / 0.2 x
               seeds 0 / 1, 5 s outages from mid-arrival span, megha also
               losing 2 GMs) for all five rules, kernel and plain runs:
               every point completes, nothing lost at fraction 0 and some
               lost elsewhere, kernel and plain final states bitwise equal,
               the fraction-0 point bitwise its fault-free run, launches
               per round; grid wall and tasks per wall second at B = 8,
               the [F, S] delays, losses, messages and megha's
               inconsistencies
  fig4_profile torch.profiler over megha's and pigeon's Fig. 4 grids,
               rounds 128-192 (inside the outage) at B = 8
  telemetry    megha (49,984 workers) and sparrow (50,000) on the megha
               phase's trace with telemetry and provenance on
               (simulate_workload(telemetry=TelemetryConfig(),
               provenance=True)), flags-off, kernel and plain runs in turns:
               final state bitwise the flags-off run's, Timeline and
               Provenance bitwise kernel = plain, gauges that account for
               every arrived task at every sample, components summing to
               the job delays, the same kernel launches and host syncs as
               the flags-off run; walls with and without the flags, the
               view-repair / inconsistency / probe totals, peak memory, and
               a Chrome trace of the first MAX_TRACE_TASKS tasks' spans
               written under the gitignored build directory
  telemetry_profile  torch.profiler over rounds 128-192 of megha's and
               sparrow's steps on that trace, with both stages off and on:
               device ops and busy time per round, idle share
  breakdown    the sweep phase's Fig. 2 grid (B = 6) for all five rules with
               provenance=True: every other column equal to the sweep
               phase's, mean_<component> summing to mean, fault rework 0,
               inconsistency retries only for megha; each rule's oracle gap
               by component, grid walls against the sweep phase's
  analysis     the static contracts and host syncs (``repro_torch.analysis``):
               speccheck on the card; every rule's state on spec after 3
               and 67 rounds of its Fig. 2 load-0.8 trace (seed 0), its
               B = 6 grid state after 3 rounds and its 4-lane curve after
               one segment (the lane axis stripped); the host syncs of
               those 64 rounds and of one stream segment (the stream
               phase's (b) configuration, the second segment) against the
               pins ``sentinels.STEP_SYNCS_PER_ROUND`` and
               ``SEGMENT_EXTRA_SYNCS`` (the ``gpu`` tests hold them too);
               ``examples/torch_quickstart.py`` on the card, its
               ``match_tasks`` kernel at 50,000 lanes bitwise its plain
               version
  fault_provenance  megha on the fig4 phase's fraction-0.1 schedule (seed 0)
               as one run with provenance=True: requeues equal the lost
               tasks and match the Fig. 4 grid's point, fault rework above 0
  eagle_long   eagle on google_like_trace() (10,000 jobs, 312,558 tasks)
               at 13,000 workers until 12.5 s through run_simulation: SSS
               rejections and central long launches, kernel and plain
               final states bitwise equal, two launches a round
  serve        the serving engine (8 frontends x 8 pods x 6,248 slots),
               kernel and plain engines in turns: identical stats and final
               state, every request completed, gm_round calls == kernel
               launches, host syncs per tick, wall, memory
  lm_serve     real-decode serving at qwen15_05b's full width (24 layers,
               d_model 1,024, bf16 compute): (a) the launcher's
               --real-decode loop (2 frontends x 2 pods x 128 slots,
               Poisson(16) requests a tick to 4,160), one pod's 128 lanes
               decoding 256 ticks against a 256-token KV cache
               (ModelRunner): every request completed, every logit finite,
               no host sync in a decode tick, match_tasks launches = gm_round
               calls, the same engine on the plain match with identical
               stats and final state, decode ms per step by CUDA events,
               lane-steps per second (every lane decodes every tick, as in
               the reference) and the served tokens of occupied lanes, the
               wall split between engine and decode, peak memory; (b)
               16 decode steps under torch.profiler: device busy and idle
               share, ops per step, the top kernels and torch ops, the
               step's byte and operations bounds; (e) two of the runner's
               ticks from position 250 (all 128 lanes, its bf16 weights and
               cache) against the same on the CPU, logits and written cache
               rows within 0.02 x max(1, max |value|); (c) decode against the
               teacher-forced forward at full width in fp32 for qwen15_05b
               and llama3_8b (weights drawn on the card), within 2e-4 x
               max(1, max |logit|); (d) two steps of (c)'s qwen on the card
               against the CPU, same bound
  lm_families  the MoE, MLA, SSM and hybrid families: (a) the launcher's
               --real-decode loop with DeepSeek-V2-Lite at its published
               width (27 layers, d_model 2,048, MLA rank 512 + 64 rope, 64
               experts top 6 + 2 shared, one leading dense layer, vocab
               padded to 102,400, bf16, weights drawn leaf by leaf from
               seed 0) on lm_serve's engine to 2,112 requests, 128 lanes
               decoding 128 ticks against a 128-token latent cache: the
               same checks as lm_serve's (a) (every request completed,
               one decode tick per engine tick to max_len, no host sync
               in a decode tick, every logit finite, match_tasks launches
               = gm_round calls, the plain engine identical), decode ms
               per step by CUDA events from step 16, lane-steps and
               served tokens per second, the share of lanes held, the
               runner's build time and peak memory; (b) 4 steps under
               torch.profiler with the step's byte and operations bounds
               (every expert's weights: the einsum dispatch computes every
               expert's capacity slots); (c) decode against the
               teacher-forced forward, each model alone on the card at full
               width: deepseek (27 layers, fp32, 8 steps), mamba2 (48
               layers, fp32, 256 steps), zamba2 (81 layers, fp32, 256
               steps), arctic cut to 1 of 35 layers (bf16, 8 steps), MoE at
               capacity factor max(16, E / k) so nothing is dropped; fp32
               within 2e-4 and bf16 within 0.02 x max(1, max |logit|), on
               the lanes whose routing agrees with the forward's (a flip
               only where the forward's k-th / (k+1)-th probability gap is
               below 1e-6 in fp32, 1e-3 in bf16, and counted); (d) 2 fp32
               steps on the card against the CPU, mamba2 at full width and
               deepseek's first two layers (the dense one and one MoE
               layer) at full width, both sides' top-k experts recorded,
               the logits within 2e-4 x max(1, max |logit|) on every lane
               whose routing agrees (a flip only at a CPU-side gap below
               1e-6); (e) the phase's wall against its 90 s budget
  train        training (``repro_torch.train``): (a) qwen15_05b at its
               full width (24 layers, d_model 1,024, vocab padded to
               152,064, tied embeddings; fp32 parameters and moments, bf16
               compute, remat "full", loss chunk 512) trained 6 steps
               through ``train_loop`` on the port's pipeline at seq 4,096,
               global batch 8 in 4 microbatches (32,768 tokens a step),
               AdamW at lr 3e-4 with 2 warmup steps, a checkpoint every 3
               steps under the gitignored build directory: loss and grad
               norm finite at every step, the loss at step 6 below step
               1's (fresh batches: within their noise), the step counter
               at 6, no host sync inside a step; ms a step by CUDA events
               over steps 3-6, tokens a second, 6 N D model FLOPs against
               the bf16 dense peak, peak memory, each checkpoint's save
               time; step 2 also under torch.profiler (the card alone):
               device busy and idle share, the top kernels; (b) restart: a
               second ``train_loop`` to 7 steps restores LATEST (step 6)
               through ``restore(like=)``, bitwise the in-memory state after
               step 6, and ends at step 7; its step (step 1's batch again:
               the loop's data starts over, as in the reference) at least
               0.1 nats below step 1's loss on that batch; (c) one train
               step on the card against the same step on the CPU from the
               same parameters and batch, every architecture's smoke config
               in fp32 (within 2e-4 x max(1, max |value|)) and bf16 (0.02
               x, the CPU tests' bound), and qwen15_05b's first 2 layers at
               full width (bf16, batch 2 x seq 256): the loss and the grad
               norm; where the routing agrees (as it must in fp32) both
               moments, and each parameter's step over the lr (AdamW at lr
               1e-2, no warmup) within 0.01 plus a rounding of the parameter
               wherever its first moment is above the moments' bound; (d)
               the phase's wall against its 75 s budget
  dryrun       the distribution specs, the dry run and the H100 roofline
               (``launch/dryrun.py``, ``roofline/``): (a) ``run_cell`` of
               qwen15_05b/train_4k and DeepSeek-V2-Lite/decode_32k on the
               (32, 8) mesh and arctic_480b/train_4k on the (2, 32, 8) mesh,
               traced on the meta device: every term finite and >= 0, FLOPs
               > 0, memory per device, the wall per cell; (b) the same dry
               run of the steps phases lm_serve (128 lanes, 256-token
               cache), lm_families (128 lanes, 128-token latent cache) and
               train (8 x 4,096 tokens) ran, on ``make_host_mesh()`` (the
               one card), with the dtypes the card ran: the predicted
               compute, memory and step terms beside the measured step (CUDA
               events) and ``max_memory_allocated``; each measured step no
               faster than 0.95 x its roofline step, the predicted resident
               state within the measured peak, the activation estimate's
               ratio to the peak printed; (c) ``FlopCounterMode`` over one of
               each served runner's ticks on the card (counted inside
               lm_serve and lm_families) equal to the meta trace of the same
               step, and ``_lm_step_ops``' total equal to it for
               qwen15_05b (DeepSeek's ratio printed); the wall against its
               30 s budget
  serve_profile  a steady window of serving ticks under torch.profiler:
               device busy and idle share, host time in torch ops; and the
               SDPS loop's gm_round likewise
  sdps         the fast path's scheduling decisions per second at 9,984 and
               49,984 workers, kernel and plain; the event backend's megha
  shard        the sharded executors (``repro_torch.simx.shard``): (a)
               ``sharded_fig2_sweep`` on ``sweep_mesh()`` (the one card) for
               the five rules' paper-scale grids and ``sharded_fig4_sweep``
               for megha's, bitwise the sweep and fig4 phases' grids, with
               their launches; (b) the reference test's indivisible
               15-point grid on a mesh naming the card twice, bitwise the
               one-entry mesh's (megha, sparrow); (c) every rule's 4-lane
               ``sharded_steady_state`` curve (the stream phase's Poisson
               stream at 25 / 35 / 40 / 45 jobs a second, loads 0.5-0.9,
               30 s; pigeon, the oracle and sparrow 15 s): each lane bitwise its
               serial ``run_steady_state`` (lane 0.8 at 30 s is the stream
               phase's (b) run), wall against the four serial walls,
               segment / refill split, tasks per wall second, one P²
               launch a segment, match launches, sketch p50 / p99 / p999,
               admission lag, utilisation, state bytes, peak memory per
               lane; (d) megha's curve with the plain
               versions to 10 s, bitwise the first 7 segments of (c)'s;
               (e) megha's and sparrow's curve to 10 s driven segment by
               segment (bitwise (c)'s first segments), segment 5 run again
               under torch.profiler: device busy and idle share a round
               over the segment's own wall
  cpu_parity   the port on the CPU against the port on the card, bitwise
               (megha, the oracle, the serving engine, the five rules'
               sweep grids at bench_simx.py's default size, and eagle with
               long jobs at 200 workers)
  kernels      one summary line per kernel

then the card's name and power limit (``nvidia-smi``), the script's wall
and each phase's (``total``) and, as the last line, the device line. Any failed check
raises, and the script exits non-zero without printing the device line; it
also fails when no card is found.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis import sentinels, speccheck  # noqa: E402
from repro_torch.analysis.specs import check_state, dims_for  # noqa: E402
from repro_torch.core import fastpath as FP  # noqa: E402
from repro_torch.configs import get_config as lm_config  # noqa: E402
from repro_torch.configs import ShapeCell, list_archs, smoke_config  # noqa: E402
from repro_torch.data.pipeline import batches as train_batches  # noqa: E402
from repro_torch.kernels import build, match, ops, p2, ref  # noqa: E402
from repro_torch.launch import dryrun as lm_dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes  # noqa: E402
from repro_torch.launch.serve import ModelRunner  # noqa: E402
from repro_torch.models import decode as lm_decode  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models.schema import init_params, map_tree, tree_items, tree_leaves  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402
from repro_torch.serve.engine import MeghaServeEngine, Request  # noqa: E402
from repro_torch.sim.simulator import run_simulation  # noqa: E402
from repro_torch.simx import convert, runtime, shard, simulate_workload, stream, sweep  # noqa: E402
from repro_torch.simx import megha as simx_megha  # noqa: E402
from repro_torch.simx import telemetry as tlm  # noqa: E402
from repro_torch.simx.faults import FaultSchedule  # noqa: E402
from repro_torch.simx.provenance import COMPONENTS, decompose_delays  # noqa: E402
from repro_torch.simx.state import SimxConfig, export_workload  # noqa: E402
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train import loop as train_loop_mod  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.workload.synth import (  # noqa: E402
    PoissonArrivals,
    ReplayArrivals,
    fixed_job_factory,
    google_like_trace,
    synthetic_trace,
)

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor FP32
#: operations/s, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

#: The paper-scale Fig. 2 point: 480 jobs x 1000 one-second tasks at load
#: 0.8 on 50,000 workers (megha shaves to 49,984 on its 8 x 8 grid).
TRACE = dict(num_jobs=480, tasks_per_job=1000, load=0.8, num_workers=50_000, seed=0)
WORKERS = 50_000
DT = 0.05
GRID_WORKERS = 49_984
DEVICE = "cuda"

#: 256 is the real-decode serving fleet of phase lm_serve (2 pods x 128)
SWEEP_WIDTHS = (1, 100, 128, 256, 1024, 8192, 50_000)
SWEEP_DTYPES = (torch.int8, torch.int32, torch.bool)
#: the batched kernel's sweep adds narrow rows that share a thread's 8
#: lanes (7) or straddle threads (33), the edges of the narrow design
#: (NARROW_MAX_LANES, +1) and of the wide tile (tile - 1, tile, tile + 1,
#: 2 tile + 1)
_TILE = match.WIDE_TILE_LANES
BATCHED_SWEEP_WIDTHS = tuple(sorted(set(SWEEP_WIDTHS) | {
    7, 33, 64, match.NARROW_MAX_LANES, match.NARROW_MAX_LANES + 1,
    _TILE - 1, _TILE, _TILE + 1, 2 * _TILE + 1}))
#: a narrow row of R = 64 queue slots per worker (the queue cap) over
#: 50,000 workers, for the dtype sweep
NARROW_SHAPE = ("queue_pick_r64", 50_000, 64)

#: bench_simx.py's SWEEP_FULL: the paper-scale Fig. 2 grid (3 loads x 2
#: seeds = 6 points per scheduler; megha's trace and run at 49,984 workers)
SWEEP_FULL = dict(loads=(0.2, 0.5, 0.8), num_seeds=2, num_workers=WORKERS, num_jobs=480,
                  tasks_per_job=1000, dt=DT)
SWEEP_POINTS = 6
#: bench_simx.py's default grid (SWEEP), for the card-against-CPU check
SWEEP_SMALL = dict(loads=(0.4, 0.8), num_seeds=2, num_workers=1024, num_jobs=32,
                   tasks_per_job=128, dt=DT)
SWEEP_RULES = ("megha", "pigeon", "oracle", "sparrow", "eagle")
#: the rules' kernel launches a round on the synthetic grid: megha's borrow
#: rounds add one each; sparrow's and eagle's one match is the head-of-queue
#: pick (no job is long there, so eagle's central match is left out)
SWEEP_PER_ROUND = {"megha": 1, "pigeon": 2, "oracle": 1, "sparrow": 1, "eagle": 1}

#: The Fig. 4 availability grid at the Fig. 2 grid's size, with the
#: severity axis of bench_simx.py's FAULTS_FULL: 4 crash fractions x 2
#: seeds = 8 points of the load-0.8 trace, 5 s outages from mid-arrival
#: span, megha also losing 2 of its 8 GMs at every nonzero fraction
FIG4_FULL = dict(fractions=(0.0, 0.05, 0.1, 0.2), num_seeds=2, outage=5.0, gm_outages=2,
                 load=0.8, num_workers=WORKERS, num_jobs=480, tasks_per_job=1000, dt=DT)
FIG4_POINTS = 8
#: the rules' kernel launches a round on the Fig. 4 grid: eagle's SSS is on
#: under faults, but no job is long, so its one match is still the pick
FIG4_PER_ROUND = SWEEP_PER_ROUND

#: the telemetry phase's rules (megha shaves to 49,984 workers) and the
#: tasks whose provenance spans go into its Chrome trace
TELEMETRY_RULES = ("megha", "sparrow")
MAX_TRACE_TASKS = 5000
#: the provenance check's tolerance on the components' sum (the
#: reference's, tests/test_simx_provenance.py)
COMPONENT_SUM_ATOL = 1e-4
#: the Fig. 4 schedule the fault_provenance phase runs: fraction 0.1
FAULT_PROVENANCE_FRACTION = 0.1

#: eagle's long path: google_like_trace() at its Table 1 size (10,000 jobs,
#: 312,558 tasks, 13,000 workers) until 12.5 simulated seconds (250
#: rounds; its last job arrives at 146.9 s, its longest task runs 2,250 s;
#: cut from 200 s, then from 100 s, then from 50 s and 25 s when phase
#: train came, to keep the script inside its time limit as phases were
#: added; 12.5 s still launches ~5,000 long tasks and rejects ~6,300 SSS
#: probes)
EAGLE_LONG_WORKERS = 13_000
EAGLE_LONG_UNTIL = 12.5

#: The main path's match shapes at the paper scale (8 GMs, 8 LMs), then
#: the Fig. 2 grid's (B = 6 points; pigeon's 1,250 groups of 40 workers)
MAIN_SHAPES = (
    ("megha_internal", 8, GRID_WORKERS // 8),
    ("megha_borrow", 8, GRID_WORKERS),
    ("oracle", 1, WORKERS),
    ("sweep_megha_internal", SWEEP_POINTS * 8, GRID_WORKERS // 8),
    ("sweep_megha_borrow", SWEEP_POINTS * 8, GRID_WORKERS),
    ("sweep_oracle", SWEEP_POINTS, WORKERS),
    ("sweep_pigeon", SWEEP_POINTS * (WORKERS // 40), 40),
)
#: sparrow's and eagle's head-of-queue pick, n = 1 per row: the Fig. 2 grid
#: at B = 6 and B = 1 (R = 40 queue slots at 50,000 workers) and eagle on
#: the google-like trace (R = 64 at 13,000 workers); then eagle's central
#: long match (n = W): on that trace, and a grid of 6 points at 50,000
PICK_SHAPES = (
    ("sweep_queue_pick", SWEEP_POINTS * WORKERS, 40),
    ("queue_pick", WORKERS, 40),
    ("eagle_long_pick", EAGLE_LONG_WORKERS, 64),
)
CENTRAL_SHAPES = (
    ("eagle_long_central", 1, EAGLE_LONG_WORKERS),
    ("eagle_central_grid", SWEEP_POINTS, WORKERS),
)
#: the Fig. 4 grid's match shapes at B = 8 (n = W, wide but for pigeon's
#: groups), then its sparrow/eagle pick (n = 1)
FIG4_SHAPES = (
    ("fig4_megha_borrow", FIG4_POINTS * 8, GRID_WORKERS),
    ("fig4_megha_internal", FIG4_POINTS * 8, GRID_WORKERS // 8),
    ("fig4_oracle", FIG4_POINTS, WORKERS),
    ("fig4_pigeon", FIG4_POINTS * (WORKERS // 40), 40),
)
FIG4_PICK_SHAPES = (
    ("fig4_queue_pick", FIG4_POINTS * WORKERS, 40),
)

#: The serving engine at the paper's 50k-worker fleet on the 8 x 8 grid:
#: 8 frontends (GMs) over 8 pods (LMs) of 6,248 slots, 49,984 slots in all.
SERVE = dict(num_frontends=8, num_pods=8, slots_per_pod=6248, max_batch=512,
             heartbeat_ticks=16)
SERVE_REQUESTS = 200_000
SERVE_ARRIVAL = 3000.0   # Poisson requests per tick: ~80 % occupancy at
SERVE_MEAN_GEN = 12      # 1 + Poisson(12) ticks of decode per request
MAX_TASKS = 512          # the serving batch and the SDPS batch

#: The single-row kernel's shapes: the serving engine and SDPS at 49,984,
#: SDPS at 9,984, and the widths of benchmarks/bench_kernels.py.
SINGLE_SHAPES = (
    ("serve_sdps", GRID_WORKERS),
    ("sdps", 9984),
    ("bench_kernels", 8192),
    ("bench_kernels", 65536),
)
SDPS_WORKERS = (10_000, 50_000)

#: Phase lm_serve: the launcher's --real-decode loop at qwen15_05b's full
#: width (bf16 compute, 24 layers, d_model 1,024, vocab padded to 152,064):
#: 2 frontends over 2 pods of 128 slots, Poisson(16) requests a tick of
#: 1 + Poisson(12) decode ticks, to 4,160 requests (258 ticks of arrivals
#: from numpy seed 0); one pod's 128 lanes decode one token a tick against a
#: 256-token KV cache, so the runner reaches max_len: 256 decode ticks (cut
#: from 8,192 requests and 512 ticks when phase train came, for the
#: script's clock)
LM_ARCH = "qwen15_05b"
LM_SERVE = dict(num_frontends=2, num_pods=2, slots_per_pod=128, max_batch=256)
LM_REQUESTS = 4160
LM_ARRIVAL = 16.0
LM_MEAN_GEN = 12
LM_MAX_LEN = 256
#: the decode steps timed by CUDA events start here (the first are warm-up)
LM_STEADY_FROM = 16
#: (b) profiles this many steps from this position (a step attends over the
#: whole cache length whatever its position, so any position does)
LM_PROFILE_STEPS = 16
LM_PROFILE_POS = 128
#: (c) decode against the teacher-forced forward at full width, fp32
#: compute, B = 2, T = 8; (d) the card against the CPU, 2 steps of qwen;
#: (e) the runner's own bf16 weights and cache, all 128 lanes, 2 ticks
#: from position 250 on the card and on the CPU
LM_CHECK_ARCHS = ("qwen15_05b", "llama3_8b")
LM_CHECK_BATCH = 2
LM_CHECK_STEPS = 8
LM_CPU_STEPS = 2
LM_LATE_POS = 250
#: the reference's own decode bound (tests/test_decode_consistency.py),
#: times max(1, max |logit|)
LM_BOUND = 2e-4
#: the bf16 bound of the CPU tests and the gpu test of bf16 decode (card
#: against CPU), times max(1, max |value|)
LM_BF16_BOUND = 0.02
#: H100 SXM dense peaks (NVIDIA data sheet) for the decode step's
#: operations bound: bf16 on the tensor cores
BF16_OPS_PER_S = 989e12

#: Phase lm_families: the MoE, MLA, SSM and hybrid families.  (a) the
#: launcher's --real-decode loop with DeepSeek-V2-Lite at its published
#: width (27 layers, d_model 2,048, MLA rank 512 + 64 rope, 64 experts top 6
#: + 2 shared, one leading dense layer, vocab padded to 102,400; bf16
#: compute, weights drawn per leaf from seed 0) on lm_serve's engine, to
#: 2,112 requests (129 ticks of arrivals from numpy seed 0; 2,100 give just
#: 128), one pod's 128 lanes decoding 128 ticks against a 128-token latent
#: cache: the depth cut from lm_serve's 4,160 requests and 256 ticks (and
#: from its own 4,160 and 256 when phase train came) for the script's
#: clock, no width cut
LMF_ARCH = "deepseek_v2_lite_16b"
LMF_REQUESTS = 2112
LMF_MAX_LEN = 128
#: (b) profiles this many steps from this position (two warm steps first;
#: a DeepSeek step is ~3,850 device ops, and reading a profile back costs
#: host time in proportion)
LMF_PROFILE_STEPS = 4
LMF_PROFILE_POS = 64
#: (c) decode against the teacher-forced forward, each model alone on the
#: card at full width, B = LM_CHECK_BATCH: (arch, layers (None: all),
#: steps, compute dtype, bound x max(1, max |logit|)).  mamba2's forward
#: needs S % chunk == 0 at its published chunk of 256; arctic is cut to 1
#: of its 35 layers (its 128 experts take 26.8 GB a layer in bf16, 960 GB
#: in all) and runs its published bf16, held to the bf16 bound
LMF_CHECKS = (
    ("deepseek_v2_lite_16b", None, 8, torch.float32, LM_BOUND),
    ("mamba2_13b", None, 256, torch.float32, LM_BOUND),
    ("zamba2_7b", None, 256, torch.float32, LM_BOUND),
    ("arctic_480b", 1, 8, torch.bfloat16, LM_BF16_BOUND),
)
#: (c) and (d) run MoE configs at this capacity factor or E / top_k, the
#: larger (the reference's decode test's 16; arctic needs 64), so that a
#: group's capacity holds every token and nothing is dropped
LMF_CAPACITY = 16.0
#: (d) the card against the CPU, LM_CPU_STEPS steps in fp32: (arch, layers)
LMF_CPU = (("mamba2_13b", None), ("deepseek_v2_lite_16b", 2))
#: a routing difference between two sides is not a fault only where the
#: reference side's gap between its k-th and (k+1)-th probability is below
#: this (fp32; the CPU tests' bf16 rule allows 1e-3)
LMF_FLIP_GAP = {torch.float32: 1e-6, torch.bfloat16: 1e-3}
#: the phase's wall budget, seconds
LMF_BUDGET_S = 90.0

#: Phase train: qwen15_05b at full width (fp32 parameters, bf16 compute,
#: remat "full", loss chunk 512: its config), the train_4k cell's seq 4,096
#: at global batch 8 in 4 microbatches (32,768 tokens a step) from the
#: port's pipeline (seed 0), 6 steps of AdamW at lr 3e-4 with 2 warmup
#: steps, a checkpoint every 3 steps; then a restart to 7 steps.  Reduced:
#: global batch 8 against train_4k's 256 (one card and the phase's clock);
#: no width cut
TRAIN_ARCH = "qwen15_05b"
TRAIN_SEQ = 4096
TRAIN_BATCH = 8
TRAIN_ACCUM = 4
TRAIN_STEPS = 6
TRAIN_RESTART_STEPS = 7
TRAIN_CKPT_EVERY = 3
TRAIN_LR = 3e-4
TRAIN_WARMUP = 2
#: the steps timed by CUDA events (0-based: steps 3 to 6), and the step
#: profiled (0-based: step 2, after the first step's allocations)
TRAIN_TIMED_FROM = 2
TRAIN_PROFILE_STEP = 1
#: the restart's step sees step 1's batch again after 6 updates: its loss
#: must be this far below step 1's (nats).  The fresh batches' losses of
#: steps 1-6 spread 0.0127 (12.1270-12.1397 on an H100), so a
#: step-1-to-6 drop is within that noise; without an update the loss would
#: not move at all
TRAIN_LEARN_MARGIN = 0.1
#: (c) qwen15_05b's first layers at full width on the card against the CPU,
#: at batch x seq
TRAIN_CPU_LAYERS = 2
TRAIN_CPU_SHAPE = (2, 256)
#: (c)'s smoke configs' batch x seq, and its step: AdamW at lr 1e-2 with no
#: warmup.  A first AdamW step moves each parameter by lr x (g / (|g| +
#: eps) + wd x p): the sign of g, so where a gradient is zero up to
#: rounding its sign may differ between the sides.  The gradients are held
#: through the moments (m = 0.1 g, v = 0.05 g^2, g clipped), and the step,
#: (p0 - p) / lr, where |m| is above the moments' bound (so its sign is
#: the same on both sides) and TRAIN_STEP_MIN_M (|g| >= 100 eps), within
#: TRAIN_STEP_REL plus one rounding of the parameter, eps(dtype) x |p| /
#: lr.  An update that does nothing, has the wrong sign or a wrong bias
#: correction is off by 0.5-2
TRAIN_SMOKE_SHAPE = (2, 32)
TRAIN_CHECK_OPT = OptConfig(lr=1e-2, warmup_steps=1)
TRAIN_STEP_REL = 0.01
TRAIN_STEP_MIN_M = 1e-7
#: (c)'s bounds on the loss and grad norm, times max(1, |value|) (fp32:
#: the reference's decode bound; bf16: the CPU tests'), and on the moments,
#: times max |moment| of the leaf (the CPU tests' gradient bounds,
#: BF16_REL for bf16)
TRAIN_BOUND = {torch.float32: LM_BOUND, torch.bfloat16: LM_BF16_BOUND}
TRAIN_MOMENT_REL = {torch.float32: 1e-3, torch.bfloat16: 0.1}
#: ... and at least this where the parameters (so the gradients) are bf16
#: (arctic's): a bf16 rounding of each gradient (the CPU tests' bound)
TRAIN_BF16_GRAD_REL = 0.01
#: the phase's wall budget, seconds
TRAIN_BUDGET_S = 75.0

#: Phase dryrun: (a) the dry run (``launch/dryrun.py``) of these cells on
#: the production H100 meshes ((32, 8) single, (2, 32, 8) multi), traced on
#: the meta device; (b) the roofline of the steps phases lm_serve,
#: lm_families and train ran, on ``make_host_mesh()`` (the one card),
#: against their measured steps: a step no faster than DRYRUN_STEP_SLACK x
#: the roofline's step time (the largest term: a bound no run can beat;
#: the slack for the measurement's noise), the predicted resident state
#: within the measured peak; (c) FlopCounterMode over one of each served
#: runner's ticks on the card equal to the meta trace of the same step
DRYRUN_CELLS = (("qwen15_05b", "train_4k", "single"),
                ("deepseek_v2_lite_16b", "decode_32k", "single"),
                ("arctic_480b", "train_4k", "multi"))
DRYRUN_STEP_SLACK = 0.95
#: the phase's wall budget, seconds
DRYRUN_BUDGET_S = 30.0

#: The streaming engine (``stream.run_steady_state``).  (a) replays the
#: megha phase's trace through a window of its full size; (b) streams
#: open-loop Poisson arrivals of the paper's job (1,000 one-second tasks)
#: at 40 jobs a second, load 0.8 by Eq. 6 at 50,000 workers, for 30
#: simulated seconds, through a window of 192 jobs and 196,608 task slots
#: (>= 2 W); (d) runs megha again to half the horizon.
STREAM_REPLAY = dict(window_jobs=480, window_tasks=480_000, rounds_per_refill=64)
STREAM_RATE = 40.0
STREAM_WINDOW = dict(window_jobs=192, window_tasks=196_608, rounds_per_refill=32)
STREAM_HORIZON = 30.0
STREAM_RULES = ("megha", "sparrow", "eagle", "pigeon", "oracle")
#: kernel launches a round under a layout: eagle's central [1, W] match
#: always runs beside its pick; megha's borrow rounds add one each
STREAM_PER_ROUND = {"megha": 1, "sparrow": 1, "eagle": 2, "pigeon": 2, "oracle": 1}
#: the profiled segment of the (f) runs (megha to 30 s, 19 segments;
#: sparrow to 10 s, 7 segments)
STREAM_PROFILE_SEGMENT = 5
STREAM_PROFILE_HORIZON = 10.0
#: The sharded executors (phase ``shard``): (b)'s indivisible grid is the
#: reference test's (5 loads x 3 seeds = 15 points, small widths), on a
#: mesh naming the card twice; (c)'s curve is four lanes of (b)'s Poisson
#: stream at 25 / 35 / 40 / 45 jobs a second, loads 0.5 / 0.7 / 0.8 / 0.9 by
#: Eq. 6 at 50,000 workers, through the stream phase's window to 30 s
SHARD_PAD_GRID = dict(loads=(0.35, 0.55, 0.7, 0.85, 0.95), num_seeds=3, num_workers=64,
                      num_jobs=6, tasks_per_job=8, dt=DT, num_gms=2, num_lms=2)
SHARD_RATES = (25.0, 35.0, 40.0, 45.0)
#: (c)'s span for pigeon and the oracle, and for sparrow (since phase
#: dryrun came), cut from 30 s to keep the script inside its time limit:
#: their four serial runs (lane 0.8 too) run to the same 15 s
SHARD_CURVE_HORIZON = {"pigeon": 15.0, "oracle": 15.0, "sparrow": 15.0}
#: (d)'s plain curve and (e)'s driven curves run to 10 s (7 segments, the
#: profiled one is segment 5) and are held to the first segments of (c)'s
#: curve: the plain P² absorb alone costs ~2 s a segment for 4 lanes
SHARD_SHORT_HORIZON = 10.0
SHARD_PROFILE_SEGMENT = 5
#: the lane-batched match shapes of the curve (4 lanes): megha internal and
#: borrow, the oracle's and eagle's central match (n = W, wide), pigeon's
#: groups (narrow), then the sparrow/eagle pick (n = 1, R = 16)
SHARD_LANES = len(SHARD_RATES)
#: phase analysis: each rule's Fig. 2 load-0.8 fixed trace runs
#: ANALYSIS_STATE_ROUNDS rounds (state checked on spec), then
#: ANALYSIS_ROUNDS more with their host syncs counted; the stream segment
#: counted is the second of the stream phase's (b) configuration
ANALYSIS_STATE_ROUNDS = 3
ANALYSIS_ROUNDS = 64
SHARD_SHAPES = (
    ("shard_megha_internal", SHARD_LANES * 8, GRID_WORKERS // 8),
    ("shard_megha_borrow", SHARD_LANES * 8, GRID_WORKERS),
    ("shard_central", SHARD_LANES, WORKERS),
    ("shard_pigeon", SHARD_LANES * (WORKERS // 40), 40),
)
SHARD_PICK_SHAPES = (
    ("shard_queue_pick", SHARD_LANES * WORKERS, 16),
)
#: the P² kernel's lane-batched shape: 4 lanes of the window's 193 job
#: slots, 57 valid a lane (the stream's timed absorb), after 300 values
SHARD_P2 = dict(lanes=SHARD_LANES, values=193, valid=57, warm=300)

#: the P² absorb's floating-point operations per observation and quantile
#: (compares, adds, multiplies, divides, two fused multiply-adds per
#: interior marker), for its throughput bound; its chain bound is timed
P2_OPS_PER_UPDATE = 100


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def device_ms(fn, iters: int = 200, warm: int = 10) -> float:
    """Device time of one call of ``fn``, from CUDA events around
    ``iters`` calls after ``warm`` ones.  A spin kernel holds the stream
    while the calls are enqueued, so the events time the device's work
    back to back and not the host's launch overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host wall time of one call of ``fn`` (launch overhead included),
    over ``iters`` calls ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def states_equal(a, b) -> bool:
    na, nb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    return all(
        na[k].dtype == nb[k].dtype and na[k].shape == nb[k].shape
        and np.array_equal(na[k], nb[k])
        for k in na
    )


def completed(metrics) -> int:
    return sum(1 for t in metrics.tasks if t.finish_time == t.finish_time)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    """Both sources at once, one nvcc each, then load and bind them."""
    t0 = time.perf_counter()
    names = ("match", "match_tasks", "p2_sketch")
    with ThreadPoolExecutor(len(names)) as pool:
        infos = list(pool.map(build.build, names))
    match._batched_fns()  # load each library and bind its C signature
    match._single_fns()
    p2._library_fns()
    out = dict(
        phase="build", seconds=time.perf_counter() - t0,
        kernels=[dict(name=i.name, library=i.library.name,
                      nvcc_seconds=i.nvcc_seconds, cached=i.cached, ptxas=i.ptxas)
                 for i in infos],
    )
    for name, i in zip(names, infos):
        want = 2 if name == "p2_sketch" else 6
        check(len(i.ptxas) == want, f"ptxas reports {want} kernel(s) of {name}.cu")
    check(all(k["spill_bytes"] == 0 for i in infos for k in i.ptxas),
          "no register spills")
    emit(out)
    return out


def _batched_case(avail, n, what: str) -> int:
    """The batched kernel against its plain version; returns the error."""
    got = match.match_ranks_batched(avail, n)
    want = ref.match_ranks_batched_ref(avail, n)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want), f"kernel == plain at {what}")
    return err


def phase_kernel(gen: torch.Generator) -> dict:
    """The sweep, then the main-path shapes and the narrow pick shape;
    returns the per-shape rows."""
    cases, worst = 0, 0
    for w in BATCHED_SWEEP_WIDTHS:
        for dtype in SWEEP_DTYPES:
            avail = (torch.rand((5, w), generator=gen) < 0.4).to(dtype).to(DEVICE)
            for n in (
                torch.tensor([0, 1, w // 2, w, w + 7], dtype=torch.int32),
                torch.randint(0, w + 1, (5,), generator=gen, dtype=torch.int32),
            ):
                worst = max(worst, _batched_case(avail, n.to(DEVICE), f"w={w} {dtype}"))
                cases += 1
            row = match.match_ranks_batched(avail[1:2].contiguous(), torch.tensor(
                [w // 2], dtype=torch.int32, device=DEVICE))
            check(torch.equal(row, ref.match_ranks_batched_ref(
                avail[1:2], torch.tensor([w // 2], dtype=torch.int32, device=DEVICE))),
                f"single row at w={w} {dtype}")
            cases += 1
    # the narrow pick shape, every dtype, n = 1 and random n per row
    caller, g, w = NARROW_SHAPE
    for dtype in SWEEP_DTYPES:
        avail = (torch.rand((g, w), generator=gen) < 0.4).to(dtype).to(DEVICE)
        for n in (torch.ones((g,), dtype=torch.int32),
                  torch.randint(0, w + 8, (g,), generator=gen, dtype=torch.int32)):
            worst = max(worst, _batched_case(avail, n.to(DEVICE), f"[{g}, {w}] {dtype}"))
            cases += 1
    emit(dict(phase="kernel", check="sweep", cases=cases, max_abs_err=worst,
              widths=list(BATCHED_SWEEP_WIDTHS), narrow_shape=[g, w],
              dtypes=[str(d) for d in SWEEP_DTYPES],
              n=["0", "1", "w/2", "w", "w+7", "random"]))

    rows = []
    # bool views as the main path passes them; n = w per row, so every
    # wide row is scanned to its end (no early exit) and the bound counts
    # every byte; the narrow picks at their own n = 1 (no early exit there)
    shapes = ([(c, g, w, w) for c, g, w in MAIN_SHAPES + CENTRAL_SHAPES + FIG4_SHAPES
               + SHARD_SHAPES]
              + [(*NARROW_SHAPE, 1)]
              + [(c, g, w, 1) for c, g, w in PICK_SHAPES + FIG4_PICK_SHAPES
                 + SHARD_PICK_SHAPES])
    for caller, g, w, n_row in shapes:
        avail = (torch.rand((g, w), generator=gen) < 0.5).to(DEVICE)
        n = torch.full((g,), n_row, dtype=torch.int32, device=DEVICE)
        err = _batched_case(avail, n, f"{caller} [{g}, {w}]")
        nbytes = g * w * (avail.element_size() + 4) + 4 * g
        r = dict(
            phase="kernel", caller=caller, shape=[g, w], dtype="bool", n=n_row,
            design=match._batched_plan(w)[0], max_abs_err=err,
            ms=device_ms(lambda: match.match_ranks_batched(avail, n)),
            plain_ms=device_ms(lambda: ref.match_ranks_batched_ref(avail, n)),
            library_ms=device_ms(lambda: torch.cumsum(avail, dim=1, dtype=torch.int32)),
            host_us=host_us(lambda: match.match_ranks_batched(avail, n)),
            plain_host_us=host_us(lambda: ref.match_ranks_batched_ref(avail, n)),
            bytes=nbytes,
            bound_ms=max(nbytes / HBM_BYTES_PER_S, g * w / SCALAR_OPS_PER_S) * 1e3,
            bound_by="bytes",
        )
        emit(r)
        rows.append(r)
    return dict(sweep_cases=cases, sweep_err=worst, rows=rows, p2_lanes=_p2_lane_case(gen))


def _p2_lane_case(gen: torch.Generator) -> dict:
    """The P² kernel at the curve's lane-batched shape: four sketches,
    each warmed with its own values, then one absorb of ``[4, 193]``
    values (57 valid a lane): bitwise its plain version lane by lane,
    timed against it, with its bound (the larger of bytes, operations and
    lane 0's dependent chain, timed in-kernel)."""
    L, N, V, warm = (SHARD_P2[k] for k in ("lanes", "values", "valid", "warm"))
    vals = torch.rand((L, warm), generator=gen).to(DEVICE) * 2.0
    sk = p2.p2_absorb(tlm.sketch_init(device=DEVICE, lanes=L), vals,
                      torch.ones_like(vals, dtype=torch.bool))
    values = (torch.rand((L, N), generator=gen) * 3.0).to(DEVICE)
    keep = torch.argsort(torch.rand((L, N), generator=gen), dim=1)[:, :V]
    mask = torch.zeros((L, N), dtype=torch.bool).scatter(1, keep, True).to(DEVICE)
    cycles = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    got = p2.p2_absorb(sk, values, mask, cycles=cycles)
    plain = tlm.sketch_absorb(sk, values, mask)
    lane_1d = [p2.p2_absorb(runtime.tree_map(lambda x, i=i: x[i], sk), values[i], mask[i])
               for i in range(L)]
    bitwise = all(torch.equal(getattr(got, f), getattr(plain, f))
                  and torch.equal(getattr(got, f), torch.stack([getattr(x, f) for x in lane_1d]))
                  for f in ("q", "n", "npd", "buf", "count"))
    check(bitwise, "P² kernel at [4, 193]: bitwise its plain version and its 1-D calls")
    hz = p2.clock_hz(DEVICE)
    n_q = sk.q.shape[-2]
    nbytes = 5 * L * N + L * (4 * (4 * n_q * 5 + 6) + 4 * (3 * n_q * 5 + 6))
    ops = P2_OPS_PER_UPDATE * n_q * L * V
    r = dict(phase="kernel", kernel="p2_sketch", shape=[L, N], valid_per_lane=V,
             max_abs_err=0.0 if bitwise else None, bitwise=bitwise,
             ms=device_ms(lambda: p2.p2_absorb(sk, values, mask)),
             one_lane_ms=device_ms(lambda: p2.p2_absorb(lane_1d[0], values[0], mask[0])),
             plain_ms=device_ms(lambda: tlm.sketch_absorb(sk, values, mask), iters=1, warm=1),
             library_ms=None, bytes=nbytes, ops=ops, sm_clock_hz=hz,
             walk_cycles_lane0=int(cycles),
             bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / SCALAR_OPS_PER_S * 1e3,
             chain_ms=int(cycles) / hz * 1e3)
    r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"], r["chain_ms"])
    r["bound_by"] = "bytes" if r["bound_ms"] == r["bytes_ms"] else "operations"
    emit(r)
    return r


def _reset_peak_memory() -> None:
    """Start a peak-memory reading from an empty cache: the allocator hands
    out a cached block whole when splitting it would leave under 1 MB, so
    blocks that earlier phases left cached would count in the peak."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_megha(wl) -> dict:
    match.match_ranks_batched.launches = 0
    _reset_peak_memory()
    t0 = time.perf_counter()
    m = run_simulation("megha", wl, num_workers=WORKERS, backend="simx", dt=DT,
                       device=DEVICE)
    wall = time.perf_counter() - t0
    launches = match.match_ranks_batched.launches
    s = m.summary()
    out = dict(
        phase="megha", entry="run_simulation", workers=GRID_WORKERS,
        tasks=wl.num_tasks, completed=completed(m),
        p50_delay=s["all_median_delay"], p95_delay=s["all_p95_delay"],
        inconsistencies=m.inconsistencies, repartitions=m.repartitions,
        messages=m.messages, kernel_launches=launches, entry_wall_s=wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    check(out["completed"] == wl.num_tasks, "megha completes every task")
    check(launches > 0, "megha launched the kernel")
    return out  # emitted by main once rounds and syncs are known


def _timed_run(wl, use_kernel: bool):
    """One simulate_workload run; returns (run, wall seconds, launches)."""
    before = match.match_ranks_batched.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = simulate_workload("megha", wl, WORKERS, dt=DT, use_kernel=use_kernel,
                            device=DEVICE)
    torch.cuda.synchronize()
    return run, time.perf_counter() - t0, match.match_ranks_batched.launches - before


def phase_megha_plain(wl, entry: dict) -> dict:
    """Kernel and plain runs in turns (kernel, plain, plain, kernel, kernel,
    plain): every final state bitwise equal, walls from one card."""
    walls = {True: [], False: []}
    launches = {True: [], False: []}
    runs = []
    for use_kernel in (True, False, False, True, True, False):
        run, wall, n = _timed_run(wl, use_kernel)
        walls[use_kernel].append(wall)
        launches[use_kernel].append(n)
        runs.append(run)
    run_k = runs[0]
    rounds = int(run_k.state.rnd)
    wall_k = float(np.median(walls[True]))
    wall_p = float(np.median(walls[False]))
    out = dict(
        phase="megha_plain", rounds=rounds, borrow_rounds=run_k.borrow_rounds,
        kernel_launches=launches[True][0],
        plain_run_launches=max(launches[False]),
        bitwise_equal=all(states_equal(run_k.state, r.state) for r in runs[1:]),
        counters_equal_entry=(
            int(run_k.state.inconsistencies) == entry["inconsistencies"]
            and int(run_k.state.repartitions) == entry["repartitions"]
            and int(run_k.state.messages) == entry["messages"]),
        walls_s=walls[True], plain_walls_s=walls[False],
        wall_s=wall_k, plain_wall_s=wall_p,
        ms_per_round=wall_k / rounds * 1e3, plain_ms_per_round=wall_p / rounds * 1e3,
        tasks_per_wall_s=wl.num_tasks / wall_k,
    )
    check(set(launches[True]) == {rounds + run_k.borrow_rounds},
          "launches == rounds + borrow rounds")
    check(launches[True][0] == entry["kernel_launches"], "same launches as the entry run")
    check(out["plain_run_launches"] == 0, "the plain run launches no kernel")
    check(out["bitwise_equal"], "kernel and plain final states are bitwise equal")
    check(out["counters_equal_entry"], "the entry run and this run agree")
    emit(out)
    return out


def phase_megha_sync(wl) -> dict:
    """Host synchronisations of one whole run, counted by torch's
    sync-debug mode (``sentinels.sync_count``)."""
    run, syncs = sentinels.sync_count(lambda: simulate_workload("megha", wl, WORKERS, dt=DT,
                                                       device=DEVICE))
    rounds = int(run.state.rnd)
    chunks = -(-rounds // 256)
    out = dict(phase="megha_sync", host_syncs=syncs, rounds=rounds,
               host_syncs_per_round=syncs / rounds,
               expected_round_loop_syncs=rounds + chunks)
    check(syncs >= rounds + chunks, "sync-debug mode counted the round loop")
    emit(out)
    return out


def _device_busy(prof) -> tuple[float, list, dict]:
    """Device busy µs (the union of the kernels' intervals), the intervals,
    and device ms by kernel name, from a torch.profiler run's raw events
    (building its ``events()`` takes seconds for a train step's ~35,000
    kernels)."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        spans.append((a, b))
        by_name[e.name()] = by_name.get(e.name(), 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, -float("inf")
    for a, b in sorted(spans):  # union of device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us, spans, by_name


def _profile_rounds(step, state, start: int, length: int,
                    kernel: str = "match_batched_wide_kernel") -> dict:
    """Rounds ``start`` to ``start + length`` of ``step`` from a fresh
    ``state``: timed once without the profiler, then again (from the same
    state) under torch.profiler; ``kernel`` names the match kernel's
    design the rounds launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = runtime.scan_rounds(step, state, start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runtime.scan_rounds(step, state, length)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runtime.scan_rounds(step, state, length)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, spans, by_name = _device_busy(prof)
    mk = [v for k, v in by_name.items() if kernel in k]
    n_mk = sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and kernel in e.name())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        rounds=[start, start + length],
        wall_ms_per_round=wall_ms / length,
        profiled_wall_ms_per_round=prof_wall_ms / length,
        device_busy_ms_per_round=busy_us / 1e3 / length,
        # busy time from the profiled pass over the wall of the same
        # rounds run without the profiler, which slows the host
        device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
        device_idle_share_profiled=1.0 - busy_us / 1e3 / prof_wall_ms,
        device_ops_per_round=len(spans) / length,
        match_kernel_launches=n_mk,
        match_kernel_us_per_launch=(sum(mk) * 1e3 / n_mk) if n_mk else None,
        match_kernel_device_share=sum(mk) * 1e3 / busy_us,
        top_device_ms=[[k[:90], v] for k, v in top],
    )


def _profile_window(wl, use_kernel: bool, start: int, length: int) -> dict:
    cfg = SimxConfig(num_workers=GRID_WORKERS, dt=DT)
    tasks = export_workload(wl, DEVICE)
    rule = runtime.get_rule("megha")
    step = rule.build_step(cfg, tasks, runtime.rule_draws(rule, cfg, tasks, 0),
                           match_fn=runtime.default_match_fn(use_kernel))
    return dict(phase="megha_profile", match="kernel" if use_kernel else "plain",
                **_profile_rounds(step, rule.init(cfg, tasks), start, length))


def phase_megha_profile(wl) -> list[dict]:
    out = []
    for use_kernel in (True, False):
        r = _profile_window(wl, use_kernel, start=128, length=64)
        check(r["device_ops_per_round"] > 0, "the profiler saw device work")
        if use_kernel:
            check(r["match_kernel_launches"] >= 64, "the window ran the wide kernel")
        emit(r)
        out.append(r)
    return out


def phase_oracle(wl, megha: dict) -> dict:
    match.match_ranks_batched.launches = 0
    t0 = time.perf_counter()
    m = run_simulation("oracle", wl, num_workers=WORKERS, backend="simx", dt=DT,
                       device=DEVICE)
    wall = time.perf_counter() - t0
    s = m.summary()
    out = dict(
        phase="oracle", entry="run_simulation", workers=WORKERS,
        completed=completed(m), p50_delay=s["all_median_delay"],
        p95_delay=s["all_p95_delay"],
        gap_p50=megha["p50_delay"] - s["all_median_delay"],
        gap_p95=megha["p95_delay"] - s["all_p95_delay"],
        kernel_launches=match.match_ranks_batched.launches, entry_wall_s=wall,
    )
    check(out["completed"] == wl.num_tasks, "the oracle completes every task")
    check(out["kernel_launches"] > 0, "the oracle launched the kernel")
    check(out["gap_p50"] >= -1e-9 and out["gap_p95"] >= -1e-9,
          "the oracle lower-bounds megha")
    emit(out)
    return out


def _grid_run(plan, draws: dict, use_kernel: bool, one_point: bool = False):
    """One batched grid run of ``plan`` with the seeds' ``draws`` on the
    card (all 6 points, or only load 0.8 / seed 0): (final state, point
    tasks, step, wall seconds, kernel launches).  The wall is the host
    clock around the step's build, the rounds and the on-device summary,
    ending in a synchronize (the draws are made once, before)."""
    sub, jsub, seeds = plan.submit_grid, plan.job_submit_grid, plan.seeds
    if one_point:
        sub, jsub, seeds = sub[-1:], jsub[-1:], seeds[:1]
        draws = {k: v[:1] for k, v in draws.items()}
    match.match_ranks_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, tasks, step = sweep.grid_state(
        plan.name, plan.cfg, plan.tasks, sub, jsub, seeds, plan.num_rounds,
        match_fn=runtime.default_match_fn(use_kernel), draws=draws)
    summary = sweep.point_summary(state, tasks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, tasks, step, summary, wall, match.match_ranks_batched.launches


def _point(state, b: int):
    return {k: v[b] for k, v in convert.state_to_numpy(state).items()}


def _summary_list(summary: dict) -> dict:
    return {k: v.cpu().tolist() for k, v in summary.items()}


def phase_sweep(megha: dict) -> dict:
    """The Fig. 2 grid for megha, pigeon, the oracle, sparrow and eagle:
    kernel run (whose launches count), plain run, and the one-point run,
    each on the card; then megha's (0.8, seed 0) point against a
    standalone run."""
    t0 = time.perf_counter()
    plans = {"megha": sweep.fig2_plan("megha", device=DEVICE, **SWEEP_FULL)}
    plans["oracle"] = sweep.fig2_plan("oracle", device=DEVICE, **SWEEP_FULL)
    # pigeon runs on the oracle's 50,000-worker load grid (built once)
    plans["pigeon"] = dataclasses.replace(plans["oracle"], name="pigeon")
    for name in ("sparrow", "eagle"):
        plans[name] = sweep.fig2_plan(name, device=DEVICE, **SWEEP_FULL)
    plan_s = time.perf_counter() - t0
    out = dict(phase="sweep", entry="fig2_plan + sweep_grid", grid=dict(
        loads=list(SWEEP_FULL["loads"]), seeds=SWEEP_FULL["num_seeds"], points=SWEEP_POINTS,
        jobs=SWEEP_FULL["num_jobs"], tasks_per_job=SWEEP_FULL["tasks_per_job"], dt=DT),
        plan_build_s=plan_s, rules={})
    finals, all_draws = {}, {}
    for name in SWEEP_RULES:
        plan = plans[name]
        t0 = time.perf_counter()
        draws = sweep.seed_draws(name, plan.cfg, plan.tasks, plan.seeds)
        draw_s = time.perf_counter() - t0
        all_draws[name] = draws
        state, tasks, step, summ, wall, launches = _grid_run(plan, draws, True)
        p_state, _, _, _, p_wall, p_launches = _grid_run(plan, draws, False)
        o_state, _, _, _, o_wall, o_launches = _grid_run(plan, draws, True, one_point=True)
        rounds = plan.num_rounds
        T = tasks.num_tasks
        borrow = getattr(step, "borrow_rounds", 0)
        r = dict(
            workers=plan.cfg.num_workers, num_rounds=rounds, tasks_per_point=T,
            draws=sorted(draws), draw_s=draw_s,
            kernel_launches=launches,
            expected_launches=SWEEP_PER_ROUND[name] * rounds + borrow,
            borrow_rounds_any=borrow,
            borrow_rounds_per_point=(step.point_borrow_rounds.tolist()
                                     if getattr(step, "point_borrow_rounds", None) is not None
                                     else None),
            plain_run_launches=p_launches, one_point_launches=o_launches,
            kernel_and_plain_bitwise=states_equal(state, p_state),
            one_point_bitwise_grid_point=all(
                np.array_equal(a, b) for a, b in zip(
                    _point(o_state, 0).values(), _point(state, SWEEP_POINTS - 2).values())),
            summary=_summary_list(summ),
            wall_s=wall, plain_wall_s=p_wall, one_point_wall_s=o_wall,
            tasks_per_wall_s=SWEEP_POINTS * T / wall,
            one_point_tasks_per_wall_s=T / o_wall,
            ms_per_round=wall / rounds * 1e3, one_point_ms_per_round=o_wall / rounds * 1e3,
            batch_speedup=SWEEP_POINTS * o_wall / wall,
        )
        if name in ("sparrow", "eagle"):
            # the queue shapes and counters: the pick runs at [B x W, R]
            R = int(state.resq.shape[-1])
            r.update(queue_slots=R, pick_shape=[SWEEP_POINTS * plan.cfg.num_workers, R],
                     one_point_pick_shape=[plan.cfg.num_workers, R],
                     res_overflow=r["summary"]["res_overflow"],
                     probe_lag=r["summary"]["probe_lag"], probes=r["summary"]["probes"],
                     long_head=(state.long_head.tolist() if name == "eagle" else None))
        check(all(v == T for v in r["summary"]["tasks_done"]),
              f"{name}: every grid point completes its {T} tasks")
        check(launches == r["expected_launches"] > 0,
              f"{name}: one kernel launch per match of the batch")
        check(p_launches == 0, f"{name}: the plain grid launches no kernel")
        check(r["kernel_and_plain_bitwise"], f"{name}: kernel and plain grids bitwise equal")
        check(r["one_point_bitwise_grid_point"],
              f"{name}: the one-point run is bitwise the grid's (0.8, 0) point")
        out["rules"][name] = r
        finals[name] = state
    # megha's (0.8, seed 0) point against a standalone run of its trace
    # (the grid's trace is built at the shaved 49,984 workers, as the
    # reference's fig2_plan builds it; the megha phase's at 50,000)
    wl = synthetic_trace(num_jobs=SWEEP_FULL["num_jobs"], load=0.8, num_workers=GRID_WORKERS,
                         tasks_per_job=SWEEP_FULL["tasks_per_job"], seed=0)
    alone = simulate_workload("megha", wl, GRID_WORKERS, dt=DT, seed=0, device=DEVICE)
    b = SWEEP_POINTS - 2  # load 0.8, seed 0
    keys = ("p50", "p95", "inconsistencies", "tasks_done", "messages")
    grid = {k: out["rules"]["megha"]["summary"][k][b] for k in keys}
    grid["repartitions"] = int(finals["megha"].repartitions[b])
    standalone = {k: v for k, v in _summary_list(
        sweep.point_summary(alone.state, alone.tasks)).items() if k in keys}
    standalone.update(repartitions=int(alone.state.repartitions), rounds=int(alone.state.rnd))
    same = ("p50", "p95", "inconsistencies", "repartitions", "tasks_done")
    out["megha_point_08_seed0"] = dict(
        grid=grid, standalone=standalone,
        grid_equals_standalone=all(grid[k] == standalone[k] for k in same),
        megha_phase=dict(p50=megha["p50_delay"], p95=megha["p95_delay"],
                         inconsistencies=megha["inconsistencies"],
                         repartitions=megha["repartitions"], trace_workers=WORKERS),
        grid_counters_equal_megha_phase=(
            grid["inconsistencies"] == megha["inconsistencies"]
            and grid["repartitions"] == megha["repartitions"]),
    )
    check(out["megha_point_08_seed0"]["grid_equals_standalone"],
          "megha's (0.8, 0) grid point equals its standalone run")
    emit(out)
    out["_plans"] = plans
    out["_draws"] = all_draws
    return out


def phase_sweep_profile(plans: dict) -> list[dict]:
    """Megha's and sparrow's grids (B = 6) under torch.profiler, rounds
    128-192 (megha's matches take the wide design, sparrow's pick the
    narrow one)."""
    out = []
    for name, kernel in (("megha", "match_batched_wide_kernel"),
                         ("sparrow", "match_batched_narrow_kernel")):
        plan = plans[name]
        step, state, _ = sweep.build_grid(
            plan.name, plan.cfg, plan.tasks, plan.submit_grid, plan.job_submit_grid,
            plan.seeds, match_fn=runtime.default_match_fn(True))
        r = dict(phase="sweep_profile", scheduler=name, points=SWEEP_POINTS,
                 **_profile_rounds(step, state, start=128, length=64, kernel=kernel))
        check(r["device_ops_per_round"] > 0, f"the profiler saw {name}'s grid device work")
        check(r["match_kernel_launches"] >= 64, f"{name}'s grid window ran its kernel")
        emit(r)
        out.append(r)
    return out


def _fault_grid_run(plan, draws: dict, use_kernel: bool):
    """One batched Fig. 4 grid run of ``plan`` on the card: (final state,
    step, summary, wall seconds, kernel launches), the wall as in
    ``_grid_run``."""
    match.match_ranks_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, step = sweep.fault_grid_state(
        plan.name, plan.cfg, plan.tasks, plan.schedules, plan.seeds, plan.num_rounds,
        match_fn=runtime.default_match_fn(use_kernel), draws=draws)
    summary = sweep.point_summary(state, plan.tasks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, step, summary, wall, match.match_ranks_batched.launches


def phase_fig4() -> dict:
    """The Fig. 4 grid (4 crash fractions x 2 seeds, B = 8) for all five
    rules: kernel run (whose launches count) and plain run, then the
    fraction-0 / seed-0 point against the same point's fault-free run."""
    t0 = time.perf_counter()
    plans = {"megha": sweep.fig4_plan("megha", device=DEVICE, **FIG4_FULL)}
    # the 50,000-worker rules share one trace and one schedule (only megha
    # takes GM outages): built once, with sparrow's probe-memory pre-flight
    plans["sparrow"] = sweep.fig4_plan("sparrow", device=DEVICE, **FIG4_FULL)
    for name in ("eagle", "pigeon", "oracle"):
        plans[name] = dataclasses.replace(plans["sparrow"], name=name)
    plan_s = time.perf_counter() - t0
    F, S = len(FIG4_FULL["fractions"]), FIG4_FULL["num_seeds"]
    out = dict(phase="fig4", entry="fig4_plan + fault_sweep_grid", grid=dict(
        fractions=list(FIG4_FULL["fractions"]), seeds=S, points=FIG4_POINTS,
        outage_s=FIG4_FULL["outage"], gm_outages_megha=FIG4_FULL["gm_outages"],
        load=FIG4_FULL["load"], jobs=FIG4_FULL["num_jobs"],
        tasks_per_job=FIG4_FULL["tasks_per_job"], dt=DT),
        plan_build_s=plan_s, rules={})
    summaries = {}
    for name in SWEEP_RULES:
        plan = plans[name]
        draws = sweep.seed_draws(name, plan.cfg, plan.tasks, plan.seeds)
        state, step, summ, wall, launches = _fault_grid_run(plan, draws, True)
        p_state, _, _, p_wall, p_launches = _fault_grid_run(plan, draws, False)
        # the fraction-0, seed-0 point without a fault schedule
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean, _, _ = sweep.grid_state(
            name, plan.cfg, plan.tasks, plan.tasks.submit[None], plan.tasks.job_submit[None],
            plan.seeds[:1], plan.num_rounds, match_fn=runtime.default_match_fn(True),
            draws={k: v[:1] for k, v in draws.items()})
        torch.cuda.synchronize()
        clean_wall = time.perf_counter() - t0
        rounds, T = plan.num_rounds, plan.tasks.num_tasks
        borrow = getattr(step, "borrow_rounds", 0)
        summary = {k: torch.reshape(v, (F, S)).cpu().tolist() for k, v in summ.items()}
        crashed = torch.isfinite(plan.schedules.worker_down).sum(dim=-1).tolist()
        r = dict(
            workers=plan.cfg.num_workers, num_rounds=rounds, tasks_per_point=T,
            fail_time_s=float(plan.annotate["fail_time"]), crashed_workers=crashed,
            gms_down=torch.isfinite(plan.schedules.gm_down).sum(dim=-1).tolist(),
            kernel_launches=launches,
            expected_launches=FIG4_PER_ROUND[name] * rounds + borrow,
            borrow_rounds_any=borrow,
            borrow_rounds_per_point=(step.point_borrow_rounds.tolist()
                                     if getattr(step, "point_borrow_rounds", None) is not None
                                     else None),
            plain_run_launches=p_launches,
            kernel_and_plain_bitwise=states_equal(state, p_state),
            zero_fraction_bitwise_fault_free=all(
                np.array_equal(a, b) for a, b in zip(
                    _point(state, 0).values(), _point(clean, 0).values())),
            p50=summary["p50"], p95=summary["p95"], lost=summary["lost"],
            messages=summary["messages"], tasks_done=summary["tasks_done"],
            inconsistencies=summary["inconsistencies"] if name == "megha" else None,
            probes=summary["probes"] if name in ("sparrow", "eagle") else None,
            res_overflow=summary["res_overflow"], probe_lag=summary["probe_lag"],
            wall_s=wall, plain_wall_s=p_wall, fault_free_point_wall_s=clean_wall,
            tasks_per_wall_s=FIG4_POINTS * T / wall, ms_per_round=wall / rounds * 1e3,
        )
        check(all(v == T for row in summary["tasks_done"] for v in row),
              f"fig4 {name}: every grid point completes its {T} tasks")
        check(all(v == 0 for v in summary["lost"][0]), f"fig4 {name}: nothing lost at fraction 0")
        check(all(v > 0 for row in summary["lost"][1:] for v in row),
              f"fig4 {name}: tasks lost at every nonzero fraction")
        check(launches == r["expected_launches"] > 0,
              f"fig4 {name}: one kernel launch per match of the batch")
        check(p_launches == 0, f"fig4 {name}: the plain grid launches no kernel")
        check(r["kernel_and_plain_bitwise"], f"fig4 {name}: kernel and plain grids bitwise equal")
        check(r["zero_fraction_bitwise_fault_free"],
              f"fig4 {name}: the fraction-0 point is bitwise its fault-free run")
        out["rules"][name] = r
        summaries[name] = summary
    emit(out)
    out["_plans"] = plans
    out["_summaries"] = summaries
    return out


def phase_fig4_profile(plans: dict) -> list[dict]:
    """Megha's and pigeon's Fig. 4 grids (B = 8) under torch.profiler,
    rounds 128-192: inside the outage, which starts at round 125."""
    out = []
    for name, kernel in (("megha", "match_batched_wide_kernel"),
                         ("pigeon", "match_batched_narrow_kernel")):
        plan = plans[name]
        step, state = sweep.build_fault_grid(
            plan.name, plan.cfg, plan.tasks, plan.schedules, plan.seeds,
            match_fn=runtime.default_match_fn(True))
        r = dict(phase="fig4_profile", scheduler=name, points=FIG4_POINTS,
                 **_profile_rounds(step, state, start=128, length=64, kernel=kernel))
        check(r["device_ops_per_round"] > 0, f"the profiler saw {name}'s Fig. 4 device work")
        check(r["match_kernel_launches"] >= 64, f"{name}'s Fig. 4 window ran its kernel")
        emit(r)
        out.append(r)
    return out


def _tel_run(name: str, wl, flags: bool, use_kernel: bool = True):
    """One simulate_workload run of the telemetry phase, with telemetry and
    provenance on or both off: (run, wall s, kernel launches, peak bytes
    allocated above what was allocated before the run)."""
    _reset_peak_memory()
    base = torch.cuda.memory_allocated()
    match.match_ranks_batched.launches = 0
    t0 = time.perf_counter()
    run = simulate_workload(name, wl, WORKERS, dt=DT, use_kernel=use_kernel, device=DEVICE,
                            telemetry=tlm.TelemetryConfig() if flags else None,
                            provenance=flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (run, wall, match.match_ranks_batched.launches,
            torch.cuda.max_memory_allocated() - base)


def _timeline_np(tl) -> dict:
    out = {"t": tl.t, "delay_hist": tl.delay_hist}
    out.update({f"series.{k}": v for k, v in tl.series.items()})
    return {k: v.cpu().numpy() for k, v in out.items()}


def _arrays_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
        for k in a)


def phase_telemetry(wl) -> dict:
    """Megha and sparrow on the megha phase's trace with telemetry and
    provenance on: runs in turns (flags off, on, on with the plain match,
    on, off), then one run each way under sync-debug mode."""
    trace_dir = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "traces"
    trace_dir.mkdir(parents=True, exist_ok=True)
    cfg = tlm.TelemetryConfig()
    out = dict(phase="telemetry", entry="simulate_workload(telemetry=, provenance=True)",
               tasks=wl.num_tasks, telemetry_config=dataclasses.asdict(cfg), rules={})
    for name in TELEMETRY_RULES:
        runs, walls, launches, peak = {}, {}, {}, {}
        for kind in ("off", "on", "on_plain", "on", "off"):
            run, wall, n, mem = _tel_run(name, wl, flags=kind != "off",
                                         use_kernel=kind != "on_plain")
            runs.setdefault(kind, run)
            walls.setdefault(kind, []).append(wall)
            launches.setdefault(kind, []).append(n)
            peak.setdefault(kind, mem)
        off, on, plain = runs["off"], runs["on"], runs["on_plain"]
        _, syncs_off = sentinels.sync_count(lambda: simulate_workload(
            name, wl, WORKERS, dt=DT, device=DEVICE))
        _, syncs_on = sentinels.sync_count(lambda: simulate_workload(
            name, wl, WORKERS, dt=DT, device=DEVICE, telemetry=cfg, provenance=True))
        rounds = int(off.state.rnd)
        tl = on.timeline
        series = tl.series
        # the gauges account for every arrived task at every sample
        arrived = torch.searchsorted(torch.sort(on.tasks.submit).values, tl.t, right=True)
        accounted = (series["pending"] + series["running"] + series["completed"]).long()
        dec = on.delay_decomposition()
        delays = on.job_delays()
        done = np.isfinite(delays)
        total = sum(np.where(done, dec[k], 0.0) for k in COMPONENTS)
        sums = {k: int(series[k].sum()) for k in ("launches", "messages", "probes",
                                                   "inconsistencies", "view_repairs")
                if k in series}
        t0 = time.perf_counter()
        spans = tlm.provenance_spans(on.provenance, on.state, on.tasks, on.cfg, pid=1,
                                     name=name, max_tasks=MAX_TRACE_TASKS)
        events = spans + tl.to_chrome_trace(pid=1)["traceEvents"]
        path = trace_dir / f"{name}_telemetry_trace.json"
        path.write_text(json.dumps({"traceEvents": events, "displayTimeUnit": "ms"}))
        trace_s = time.perf_counter() - t0
        wall_off, wall_on = float(np.median(walls["off"])), float(np.median(walls["on"]))
        r = dict(
            workers=on.cfg.num_workers, rounds=rounds, samples=tl.num_samples,
            kernel_launches=launches["on"][0], flags_off_launches=launches["off"][0],
            plain_run_launches=max(launches["on_plain"]),
            host_syncs=syncs_on, flags_off_host_syncs=syncs_off,
            host_syncs_per_round=syncs_on / rounds,
            state_bitwise_flags_off=states_equal(on.state, off.state),
            kernel_and_plain_bitwise=(
                _arrays_equal(_timeline_np(tl), _timeline_np(plain.timeline))
                and states_equal(on.provenance, plain.provenance)
                and states_equal(on.state, plain.state)),
            gauges_account_for_every_task=bool(torch.equal(accounted, arrived)),
            components_finite_where_done=all(
                np.array_equal(np.isfinite(dec[k]), done) for k in COMPONENTS),
            component_sum_max_abs_err=float(np.max(np.abs(total[done] - delays[done]))),
            series_totals=sums,
            state_totals=dict(messages=int(on.state.messages), probes=int(on.state.probes),
                              inconsistencies=int(on.state.inconsistencies)),
            requeues=int(on.provenance.requeue_count.sum()),
            stale_retries=int(on.provenance.stale_retry_count.sum()),
            mean_delay=float(np.nanmean(delays)),
            mean_components={k: float(np.nanmean(dec[k])) for k in COMPONENTS},
            delay_hist=tl.delay_hist.tolist(),
            walls_s=walls["on"], flags_off_walls_s=walls["off"], plain_walls_s=walls["on_plain"],
            wall_s=wall_on, flags_off_wall_s=wall_off, wall_ratio=wall_on / wall_off,
            ms_per_round=wall_on / rounds * 1e3, flags_off_ms_per_round=wall_off / rounds * 1e3,
            peak_bytes=peak["on"], flags_off_peak_bytes=peak["off"],
            trace_file=str(path.relative_to(ROOT)), trace_bytes=path.stat().st_size,
            trace_events=len(events), trace_span_tasks=min(MAX_TRACE_TASKS, on.tasks_completed),
            trace_s=trace_s,
        )
        check(on.tasks_completed == wl.num_tasks, f"telemetry {name}: completes every task")
        check(r["state_bitwise_flags_off"], f"telemetry {name}: state bitwise the flags-off run's")
        check(r["kernel_and_plain_bitwise"],
              f"telemetry {name}: Timeline, Provenance and state bitwise kernel = plain")
        check(r["gauges_account_for_every_task"],
              f"telemetry {name}: pending + running + completed = arrived at every sample")
        check(r["components_finite_where_done"]
              and r["component_sum_max_abs_err"] <= COMPONENT_SUM_ATOL,
              f"telemetry {name}: the components sum to the job delays")
        check(set(launches["on"]) == set(launches["off"]) and launches["on"][0] > 0,
              f"telemetry {name}: the flags add no kernel launch")
        check(r["plain_run_launches"] == 0, f"telemetry {name}: the plain run launches no kernel")
        check(syncs_on == syncs_off and syncs_on >= -(-rounds // 256),
              f"telemetry {name}: the flags add no host sync")
        if rounds % cfg.stride == 0:
            check(all(sums[k] == r["state_totals"][k] for k in r["state_totals"]),
                  f"telemetry {name}: the series' counters sum to the state's")
        out["rules"][name] = r
    emit(out)
    return out


def phase_telemetry_profile(wl) -> list[dict]:
    """Rounds 128-192 of megha's and sparrow's steps on the telemetry
    phase's trace under torch.profiler, with both stages off and on (the
    telemetry step's counters are computed and dropped; the window-end
    gauges, one sample in 8 rounds, are left out)."""
    from repro_torch.simx.provenance import init_provenance

    tasks = export_workload(wl, DEVICE)
    out = []
    for name, workers, kernel in (("megha", GRID_WORKERS, "match_batched_wide_kernel"),
                                  ("sparrow", WORKERS, "match_batched_narrow_kernel")):
        cfg = SimxConfig(num_workers=workers, dt=DT)
        rule = runtime.get_rule(name)
        draws = runtime.rule_draws(rule, cfg, tasks, 0)
        for flags in (False, True):
            step = rule.build_step(cfg, tasks, draws, match_fn=runtime.default_match_fn(True),
                                   telemetry=flags, provenance=flags)
            state = rule.init(cfg, tasks)
            if flags:
                state = (state, init_provenance(tasks.num_tasks, DEVICE))
                step = (lambda tel_step: lambda c: tel_step(c)[0])(step)
            r = dict(phase="telemetry_profile", scheduler=name, stages=flags,
                     **_profile_rounds(step, state, start=128, length=64, kernel=kernel))
            check(r["device_ops_per_round"] > 0, f"the profiler saw {name}'s device work")
            check(r["match_kernel_launches"] >= 64, f"{name}'s window ran its kernel")
            emit(r)
            out.append(r)
    return out


def phase_breakdown(swp: dict, plans: dict, draws: dict) -> dict:
    """The sweep phase's Fig. 2 grids again, with provenance: every column
    of the sweep phase plus mean_<component>, and each rule's oracle gap
    split by component."""
    out = dict(phase="breakdown", entry="sweep_grid(provenance=True)", points=SWEEP_POINTS,
               components=list(COMPONENTS), rules={})
    cols = {}
    for name in SWEEP_RULES:
        plan = plans[name]
        match.match_ranks_batched.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = sweep.sweep_grid(
            plan.name, plan.cfg, plan.tasks, plan.submit_grid, plan.job_submit_grid,
            plan.seeds, plan.num_rounds, match_fn=runtime.default_match_fn(True),
            draws=draws[name], provenance=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = match.match_ranks_batched.launches
        summ = {k: v.reshape(-1).cpu().numpy() for k, v in grid.items()}
        ref = swp["rules"][name]
        total = sum(summ[f"mean_{k}"] for k in COMPONENTS)
        r = dict(
            kernel_launches=launches, flags_off_launches=ref["kernel_launches"],
            columns_equal_sweep=all(
                np.array_equal(summ[k], np.asarray(v), equal_nan=True)
                for k, v in ref["summary"].items()),
            mean=summ["mean"].tolist(),
            **{f"mean_{k}": summ[f"mean_{k}"].tolist() for k in COMPONENTS},
            component_sum_max_abs_err=float(np.max(np.abs(total - summ["mean"]))),
            wall_s=wall, flags_off_wall_s=ref["wall_s"], wall_ratio=wall / ref["wall_s"],
            ms_per_round=wall / plan.num_rounds * 1e3,
        )
        check(r["columns_equal_sweep"], f"breakdown {name}: the sweep phase's columns")
        check(r["component_sum_max_abs_err"] <= COMPONENT_SUM_ATOL,
              f"breakdown {name}: mean_<component> sums to mean")
        check(not np.any(summ["mean_fault_rework"]), f"breakdown {name}: no fault rework")
        retry = summ["mean_inconsistency_retry"]
        check(bool(np.any(retry > 0)) if name == "megha" else not np.any(retry),
              f"breakdown {name}: inconsistency retries for megha only")
        check(launches == ref["kernel_launches"] > 0,
              f"breakdown {name}: the flag adds no kernel launch")
        out["rules"][name] = r
        cols[name] = summ
    # each rule's gap above the oracle at every point, by component
    for name in SWEEP_RULES:
        out["rules"][name]["oracle_gap"] = {
            k: (cols[name][k] - cols["oracle"][k]).tolist()
            for k in ["mean"] + [f"mean_{c}" for c in COMPONENTS]}
    emit(out)
    return out


def _quickstart_module():
    """``examples/torch_quickstart.py`` as a module (it is a script, not a
    package member)."""
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_analysis(plans: dict, draws: dict) -> dict:
    """The static contracts and host syncs at the paper's size: (a)
    ``speccheck.run_all`` on the card; (b) ``check_state`` on every rule's
    state after 3 rounds of its Fig. 2 load-0.8 trace (seed 0) at 50,000
    workers (megha 49,984) and after 64 more, on its B = 6 Fig. 2 grid state
    (3 rounds) and on its 4-lane curve after one segment (state, stacked
    windows and layouts, sketch, the lane axis stripped); (c) the host
    syncs of those 64 rounds and of one stream segment (the second, stream
    phase (b)'s configuration), each held to the pin
    ``sentinels.STEP_SYNCS_PER_ROUND`` the gpu tests hold; (d) the
    quickstart on the card, its kernel check included."""
    t_phase = time.perf_counter()
    out = dict(phase="analysis", rounds=ANALYSIS_ROUNDS, state_rounds=ANALYSIS_STATE_ROUNDS,
               segment_rounds=STREAM_WINDOW["rounds_per_refill"],
               pinned_syncs_per_round=dict(sentinels.STEP_SYNCS_PER_ROUND),
               segment_extra_syncs=dict(sentinels.SEGMENT_EXTRA_SYNCS), rules={})

    # (a) every speccheck check on the card
    t0 = time.perf_counter()
    rep = speccheck.run_all(device=DEVICE)
    out["speccheck"] = dict(checks=[r["check"] for r in rep.results], failures=rep.failures,
                            wall_s=time.perf_counter() - t0)
    check(rep.failures == 0, f"speccheck on the card: {[r for r in rep.results if not r['ok']]}")

    seg_rounds = STREAM_WINDOW["rounds_per_refill"]
    home = torch.device(DEVICE)
    for name in SWEEP_RULES:
        t_rule = time.perf_counter()
        rule, plan = runtime.get_rule(name), plans[name]
        pin = sentinels.STEP_SYNCS_PER_ROUND[name]
        dims = dims_for(plan.cfg, plan.tasks)
        # (b, c) one point of the Fig. 2 grid: load 0.8, seed 0
        tasks = plan.tasks.replace(submit=plan.submit_grid[-1],
                                   job_submit=plan.job_submit_grid[-1])
        step = rule.build_step(plan.cfg, tasks, {k: v[0] for k, v in draws[name].items()})
        state = runtime.batch_state(rule.init(plan.cfg, tasks))
        state = runtime.scan_rounds(step, state, ANALYSIS_STATE_ROUNDS)
        check_state(state, dict(dims), lead=("B",), where=f"{name} round {ANALYSIS_STATE_ROUNDS}")
        torch.cuda.synchronize()
        match.match_ranks_batched.launches = 0
        borrow = getattr(step, "borrow_rounds", 0)
        with sentinels.count_syncs() as fixed:
            state = runtime.scan_rounds(step, state, ANALYSIS_ROUNDS)
            torch.cuda.synchronize()
        launches = match.match_ranks_batched.launches
        borrow = getattr(step, "borrow_rounds", 0) - borrow
        last = ANALYSIS_STATE_ROUNDS + ANALYSIS_ROUNDS
        check_state(state, dict(dims), lead=("B",), where=f"{name} round {last}")
        # (b) the B = 6 grid state after 3 rounds
        g_state, _, _ = sweep.grid_state(
            plan.name, plan.cfg, plan.tasks, plan.submit_grid, plan.job_submit_grid,
            plan.seeds, ANALYSIS_STATE_ROUNDS, draws=draws[name])
        check_state(g_state, dict(dims, B=SWEEP_POINTS), lead=("B",), where=f"{name} grid")
        del g_state
        # (c) one stream segment: the second, after a refill
        loop = stream._SteadyLoop(name, [_stream_arrivals()], WORKERS, devices=(home,), dt=DT,
                                  horizon=STREAM_HORIZON, **STREAM_WINDOW)
        loop.refill(loop.segment())
        torch.cuda.synchronize()
        with sentinels.count_syncs() as segment:
            seg = loop.segment()
        sdims = dict(W=loop.cfg.num_workers, G=loop.cfg.num_gms, L=loop.cfg.num_lms,
                     NG=loop.cfg.num_groups, T=loop.wins[0].T_cap, J=loop.wins[0].J_cap)
        check_state(seg["state"], dict(sdims), lead=("B",), where=f"{name} stream")
        del loop, seg
        # (b) the 4-lane curve after one segment, the lane axis stripped
        curve = stream._SteadyLoop(
            name, [_shard_arrivals(r) for r in SHARD_RATES], WORKERS,
            devices=shard.sweep_mesh(device=DEVICE), entry="sharded_steady_state", dt=DT,
            horizon=STREAM_HORIZON, **STREAM_WINDOW)
        seg = curve.segment()
        lane = ("lanes",)
        ldims = dict(sdims, lanes=SHARD_LANES)
        check_state(seg["state"], dict(ldims), lead=lane, where=f"{name} curve state")
        check_state(stream._stack_tasks(curve.wins, home), dict(ldims), lead=lane,
                    where=f"{name} curve windows")
        if curve.wins[0].layout() is not None:
            check_state(runtime.tree_join(torch.stack, [w.layout() for w in curve.wins]),
                        dict(ldims), lead=lane, where=f"{name} curve layouts")
        check_state(seg["sketch"], {"lanes": SHARD_LANES}, lead=lane,
                    where=f"{name} curve sketch")
        del curve, seg
        r = dict(
            workers=plan.cfg.num_workers, fixed_rounds=ANALYSIS_ROUNDS,
            fixed_syncs=fixed.count, fixed_syncs_per_round=fixed.count / ANALYSIS_ROUNDS,
            fixed_kernel_launches=launches, fixed_borrow_rounds=borrow,
            segment_rounds=seg_rounds,
            fixed_sync_sites=dict(fixed.sites), segment_syncs=segment.count,
            segment_syncs_per_round=segment.count / seg_rounds,
            segment_sync_sites=dict(segment.sites),
            pinned_syncs_per_round=pin, states_on_spec=[
                f"round {ANALYSIS_STATE_ROUNDS}", f"round {last}", "grid B=6",
                "stream segment", "4-lane curve"],
            wall_s=time.perf_counter() - t_rule)
        check(fixed.count <= pin * ANALYSIS_ROUNDS,
              f"{name}: {fixed.count} host syncs in {ANALYSIS_ROUNDS} rounds, pinned "
              f"at {pin} a round")
        extra = sentinels.SEGMENT_EXTRA_SYNCS[name]
        check(segment.count <= pin * seg_rounds + extra,
              f"{name}: {segment.count} host syncs in a {seg_rounds}-round segment, pinned "
              f"at {pin} a round + {extra}")
        check(launches == SWEEP_PER_ROUND[name] * ANALYSIS_ROUNDS + borrow,
              f"{name}: one kernel launch per match")
        out["rules"][name] = r

    # (d) the quickstart on the card
    t0 = time.perf_counter()
    qs = _quickstart_module().main(device=DEVICE)
    out["quickstart"] = dict(kernel=qs["kernel"], consistency=qs["consistency"],
                             sweep_p50={k: float(v["p50"][0, 0]) for k, v in qs["sweep"].items()},
                             wall_s=time.perf_counter() - t0)
    check(qs["kernel"]["kernel_launches"] == 1 and qs["kernel"]["equal"],
          "the quickstart's match_tasks kernel launched once and equals its plain version")
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_fault_provenance(fig4: dict, plans: dict) -> dict:
    """Megha under the Fig. 4 fraction-0.1 schedule (seed 0's draws) as one
    run with provenance: the lost tasks' requeues and rework."""
    plan = plans["megha"]
    fi = list(FIG4_FULL["fractions"]).index(FAULT_PROVENANCE_FRACTION)
    row = FaultSchedule(**{f.name: getattr(plan.schedules, f.name)[fi]
                           for f in dataclasses.fields(FaultSchedule)})
    draws = {k: v[0] for k, v in sweep.seed_draws("megha", plan.cfg, plan.tasks,
                                                   plan.seeds[:1]).items()}
    match.match_ranks_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, prov = runtime.simulate_fixed(
        "megha", plan.cfg, plan.tasks, draws, plan.num_rounds,
        match_fn=runtime.default_match_fn(True), faults=row, provenance=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = match.match_ranks_batched.launches
    dec = decompose_delays(prov, state.task_finish, state.t, plan.tasks, plan.cfg.dt)
    delays = dec["delays"]
    total = sum(torch.where(torch.isfinite(delays), dec[k], 0.0) for k in COMPONENTS)
    done = torch.isfinite(delays)
    out = dict(
        phase="fault_provenance", entry="simulate_fixed(faults=, provenance=True)",
        workers=plan.cfg.num_workers, tasks=plan.tasks.num_tasks, rounds=plan.num_rounds,
        fraction=FAULT_PROVENANCE_FRACTION, seed=0,
        crashed_workers=int(torch.isfinite(row.worker_down).sum()),
        gms_down=int(torch.isfinite(row.gm_down).sum()),
        tasks_done=int((state.task_finish <= state.t).sum()),
        lost=int(state.lost), requeues=int(prov.requeue_count.sum()),
        fig4_grid_lost=fig4["rules"]["megha"]["lost"][fi][0],
        tasks_requeued=int((prov.requeue_count > 0).sum()),
        max_requeues=int(prov.requeue_count.max()),
        stale_retries=int(prov.stale_retry_count.sum()),
        fault_rework_sum_s=float(torch.nansum(dec["fault_rework"])),
        jobs_with_rework=int((dec["fault_rework"] > 0).sum()),
        mean_delay=float(torch.nanmean(delays)),
        mean_components={k: float(torch.nanmean(dec[k])) for k in COMPONENTS},
        component_sum_max_abs_err=float((total - torch.where(done, delays, 0.0)).abs().max()),
        kernel_launches=launches, wall_s=wall, ms_per_round=wall / plan.num_rounds * 1e3,
    )
    check(out["tasks_done"] == plan.tasks.num_tasks, "fault_provenance: every task completes")
    check(out["requeues"] > 0 and out["requeues"] == out["lost"],
          "fault_provenance: each lost task is requeued once")
    check(out["lost"] == out["fig4_grid_lost"], "fault_provenance: the Fig. 4 grid's point")
    check(out["fault_rework_sum_s"] > 0, "fault_provenance: fault rework above 0")
    check(out["component_sum_max_abs_err"] <= COMPONENT_SUM_ATOL,
          "fault_provenance: the components sum to the job delays")
    check(launches > 0, "fault_provenance: launched the kernel")
    emit(out)
    return out


def _stream_run(name: str, arrivals, use_kernel: bool = True, horizon: float | None = STREAM_HORIZON,
                window: dict = STREAM_WINDOW, orders=None):
    """One ``run_steady_state`` on the card: (run, wall seconds, match
    launches, P² launches, peak bytes).  The counts are set to 0 just
    before the run and read just after it."""
    match.match_ranks_batched.launches = 0
    p2.p2_absorb.launches = 0
    _reset_peak_memory()
    t0 = time.perf_counter()
    run = stream.run_steady_state(
        name, arrivals, WORKERS, dt=DT, horizon=horizon, use_kernel=use_kernel,
        orders=orders, device=DEVICE, **window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (run, wall, match.match_ranks_batched.launches, p2.p2_absorb.launches,
            torch.cuda.max_memory_allocated())


def _stream_arrivals():
    return PoissonArrivals(rate=STREAM_RATE, job_factory=fixed_job_factory(1000, 1.0), seed=7)


def _runs_bitwise(a, b) -> bool:
    """Two streamed runs agree bitwise: delays, series, refills, sketch."""
    return (np.array_equal(a.delays, b.delays) and a.refills == b.refills
            and set(a.series) == set(b.series)
            and all(np.array_equal(a.series[k], b.series[k], equal_nan=True) for k in a.series)
            and np.array_equal(a.quantile_estimates, b.quantile_estimates, equal_nan=True))


def _stream_by_segment(name: str, horizon: float, orders=None, record: list | None = None,
                       profile_segment: int | None = None) -> dict:
    """``run_steady_state``'s loop (no telemetry or provenance), driven
    segment by segment from ``simx/stream.py``'s own window and
    ``_segment_core`` on the (b) configuration, so that (e) can record
    every absorb's inputs and (f) can profile one segment.  ``record``
    collects ``(sketch, values, mask, result)`` of each absorb.  Segment
    ``profile_segment`` runs twice from the same inputs: timed, then under
    torch.profiler; the two must agree.  Returns the retired delays, the
    per-refill sketch quantiles and host walls, and the profile."""
    from torch.profiler import ProfilerActivity, profile

    r = runtime.get_rule(name)
    cfg = stream.stream_config(name, WORKERS, window_tasks=STREAM_WINDOW["window_tasks"], dt=DT)
    win = stream._StreamWindow(_stream_arrivals(), cfg, name, STREAM_WINDOW["window_jobs"],
                               STREAM_WINDOW["window_tasks"], 0, torch.device(DEVICE))
    win_tasks = win.tasks()
    megha_orders = None
    if name == "megha":
        draws = runtime.orders_as_draws(orders, None)
        megha_orders = runtime.rule_draws(r, cfg, win_tasks, draws)["orders"].to(DEVICE)
    state = runtime.batch_state(r.init(cfg, win_tasks))
    sketch = tlm.sketch_init(device=DEVICE, lanes=1)
    recording = [record is not None]

    def absorb(sk, values, mask):
        out = p2.p2_absorb(sk, values, mask)
        if recording[0]:
            record.append((sk, values.clone(), mask.clone(), out))
        return out

    seg = stream._segment_core(name, cfg, STREAM_WINDOW["rounds_per_refill"],
                               runtime.default_match_fn(True), megha_orders, absorb=absorb)
    queues = r.has_queues

    def advance(state, sketch):
        state, sketch, _, _, _ = seg(state, win_tasks, win.layout(), sketch)
        head = [state.probe_head.double()] if queues else []
        scal = torch.cat([state.t.double(), state.lost.double(), *head,
                          tlm.sketch_quantiles(sketch)[0].double()]).cpu().numpy()
        return state, sketch, scal

    quantiles, seg_ms, refill_ms, prof = [], [], [], None
    while True:
        t0 = time.perf_counter()
        new_state, new_sketch, scal = advance(state, sketch)
        seg_ms.append((time.perf_counter() - t0) * 1e3)
        if len(seg_ms) - 1 == profile_segment:
            recording[0] = False
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                again, _, scal_again = advance(state, sketch)
                prof_ms = (time.perf_counter() - t0) * 1e3
            recording[0] = record is not None
            check(np.array_equal(scal_again, scal, equal_nan=True)
                  and torch.equal(again.task_finish, new_state.task_finish),
                  f"{name} stream: the profiled segment repeats the timed one")
            prof = (p, prof_ms)
        state, sketch = new_state, new_sketch
        t1 = time.perf_counter()
        t_now = float(np.float32(scal[0]))
        state, _, _ = win.refill(state, t_now, int(scal[1]), int(scal[2]) if queues else 0)
        quantiles.append(np.float32(scal[3 if queues else 2:]))
        stop = win.drained or t_now >= horizon
        if not stop:
            win_tasks = win.tasks()
        refill_ms.append((time.perf_counter() - t1) * 1e3)
        if stop:
            break
    return dict(delays=np.asarray(win.retired_delays, np.float64),
                quantiles=np.stack(quantiles), segment_ms=seg_ms, refill_ms=refill_ms,
                profile=prof)


def _segment_profile(name: str, by_seg: dict) -> dict:
    """(f): the profiled segment's device busy time over its own wall
    without the profiler (the timed pass of the same segment, same
    inputs), and over its wall under the profiler; the refill after it."""
    prof, prof_ms = by_seg["profile"]
    i = STREAM_PROFILE_SEGMENT
    seg_rounds = STREAM_WINDOW["rounds_per_refill"]
    busy_us, spans, by_name = _device_busy(prof)
    seg_ms = by_seg["segment_ms"][i]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        segment=i, rounds=seg_rounds, segments=len(by_seg["segment_ms"]),
        device_busy_ms_per_round=busy_us / 1e3 / seg_rounds,
        device_ops_per_round=len(spans) / seg_rounds,
        segment_wall_ms=seg_ms, segment_wall_ms_per_round=seg_ms / seg_rounds,
        profiled_segment_wall_ms=prof_ms,
        device_idle_share=1.0 - busy_us / 1e3 / seg_ms,
        device_idle_share_profiled=1.0 - busy_us / 1e3 / prof_ms,
        refill_host_ms=by_seg["refill_ms"][i],
        refill_host_ms_mean=float(np.mean(by_seg["refill_ms"])),
        p2_kernel_ms=sum(v for k, v in by_name.items() if "p2_absorb" in k),
        top_device_ms=[[k[:90], v] for k, v in top])


def phase_stream(wl) -> dict:
    """The streaming engine at the paper's size: (a) replay parity, (b)
    all five rules under open-loop load, (c) kernel = plain, (d) the state
    bytes independent of the span, (e) the P² kernel against its plain
    version, (f) one segment under the profiler."""
    t_phase = time.perf_counter()
    out = dict(phase="stream", workers=WORKERS, megha_workers=GRID_WORKERS,
               arrival_rate=STREAM_RATE, horizon=STREAM_HORIZON, dt=DT, **STREAM_WINDOW)
    cfg = SimxConfig(num_workers=GRID_WORKERS, dt=DT)
    orders = simx_megha.gm_orders(torch.Generator().manual_seed(0), cfg)
    offered = _stream_arrivals().offered_load(WORKERS)
    out["offered_load"] = offered
    check(abs(offered - 0.8) < 1e-12, "the Poisson stream offers load 0.8 (Eq. 6)")

    # (a) replay parity: the full-size window IS the fixed trace
    out["replay"] = {}
    jobs = wl.sorted_jobs()
    for name in ("megha", "oracle"):
        kw = dict(orders=orders) if name == "megha" else {}
        fixed = simulate_workload(name, wl, WORKERS, dt=DT, device=DEVICE, **kw)
        jf = fixed.job_finish_times()
        want = np.sort([float(np.float32(jf[p])) - float(j.submit_time) - float(j.ideal_jct)
                        for p, j in enumerate(jobs)])
        run, wall, launches, p2_launches, peak = _stream_run(
            name, ReplayArrivals(wl), horizon=None, window=STREAM_REPLAY,
            orders=orders if name == "megha" else None)
        got = np.sort(run.delays)
        out["replay"][name] = dict(
            tasks=run.tasks_completed, jobs=run.jobs_completed, refills=len(run.refills),
            rounds=run.rounds, fixed_rounds=int(fixed.state.rnd), wall_s=wall,
            delays_bitwise_fixed=bool(got.shape == want.shape and np.array_equal(got, want)),
            match_launches=launches, p2_launches=p2_launches,
            max_memory_allocated=peak)
        check(run.tasks_completed == wl.num_tasks, f"{name} replay: every task completes")
        check(out["replay"][name]["delays_bitwise_fixed"],
              f"{name} replay: sorted delays bitwise the fixed run's")
        del fixed

    # (b) every rule under open-loop Poisson load, 30 simulated seconds
    out["rules"], runs = {}, {}
    for name in STREAM_RULES:
        run, wall, launches, p2_launches, peak = _stream_run(
            name, _stream_arrivals(), orders=orders if name == "megha" else None)
        runs[name] = run
        balanced = all(s["admitted"] == s["completed"] + s["running"] + s["pending"]
                       + s["unarrived"] + s["lost"] for s in run.refills)
        want_launches = STREAM_PER_ROUND[name] * run.rounds + run.borrow_rounds
        lag = run.series["admission_lag"]
        r = out["rules"][name] = dict(
            workers=run.cfg.num_workers, wall_s=wall, rounds=run.rounds,
            refills=len(run.refills), end_time=run.end_time,
            jobs_admitted=run.jobs_admitted, jobs_completed=run.jobs_completed,
            tasks_admitted=run.tasks_admitted, tasks_completed=run.tasks_completed,
            tasks_per_wall_s=run.tasks_completed / wall,
            segment_s=run.segment_seconds, refill_s=run.refill_seconds,
            refill_share=run.refill_seconds / wall,
            admission_lag_max=float(lag.max()), admission_lag_last=float(lag[-1]),
            p50=run.quantile(0.5), p95=run.quantile(0.95), p99=run.quantile(0.99),
            p999=run.quantile(0.999), exact_p50=float(np.quantile(run.delays, 0.5)),
            exact_p99=float(np.quantile(run.delays, 0.99)),
            mean_utilization=run.mean_utilization, state_bytes=run.state_bytes,
            max_memory_allocated=peak, lost=run.lost, messages=run.messages,
            probes=run.probes, borrow_rounds=run.borrow_rounds,
            ledger_balanced_every_refill=balanced,
            kernel_launches=launches, expected_launches=want_launches,
            p2_launches=p2_launches)
        check(balanced, f"{name} stream: ledger balanced at every refill")
        check(run.lost == 0, f"{name} stream: nothing lost")
        check(run.end_time >= STREAM_HORIZON, f"{name} stream: reached the horizon")
        check(launches == want_launches, f"{name} stream: match launches = rounds x "
              f"{STREAM_PER_ROUND[name]} + borrow rounds")
        check(p2_launches == len(run.refills), f"{name} stream: one P² launch per refill")
        check(run.jobs_completed > 0 and run.mean_utilization > 0.1,
              f"{name} stream: jobs retire and workers are busy")

    # (c) kernel = plain, for megha (wide + borrow) and eagle (pick + central)
    out["plain"] = {}
    for name in ("megha", "eagle"):
        run, wall, launches, p2_launches, _ = _stream_run(
            name, _stream_arrivals(), use_kernel=False,
            orders=orders if name == "megha" else None)
        same = _runs_bitwise(run, runs[name])
        out["plain"][name] = dict(wall_s=wall, bitwise_kernel=same,
                                  match_launches=launches, p2_launches=p2_launches)
        check(same, f"{name} stream: kernel = plain bitwise")
        check(launches == 0 and p2_launches == 0, f"{name} plain stream launches nothing")

    # (d) the O(W + window) claim: half the span, the same carried bytes
    half, _, _, _, _ = _stream_run("megha", _stream_arrivals(), horizon=STREAM_HORIZON / 2,
                                   orders=orders)
    out["state_bytes"] = dict(horizon_15=half.state_bytes,
                              horizon_30=runs["megha"].state_bytes)
    check(half.state_bytes == runs["megha"].state_bytes,
          "megha stream: state bytes equal at 15 s and 30 s")

    # (e) the P² kernel against its plain version on every segment's
    # delays of megha's (b) run, driven segment by segment (which also
    # profiles its segment 5 for (f)); the driven loop is held bitwise to
    # the entry point's run
    p2_log: list = []
    by_seg = {"megha": _stream_by_segment("megha", STREAM_HORIZON, orders, record=p2_log,
                                          profile_segment=STREAM_PROFILE_SEGMENT)}
    qkeys = [f"q{q}" for q in tlm.DEFAULT_QUANTILES]
    want_q = np.stack([runs["megha"].series[k] for k in qkeys], axis=1).astype(np.float32)
    check(np.array_equal(by_seg["megha"]["delays"], runs["megha"].delays)
          and np.array_equal(by_seg["megha"]["quantiles"], want_q, equal_nan=True),
          "megha stream: the driven segments are bitwise the entry point's run")
    bitwise, n_obs = True, []
    cycles = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    walk_cycles = []
    for sk, values, mask, got in p2_log:
        kern = p2.p2_absorb(sk, values, mask, cycles=cycles)
        walk_cycles.append(int(cycles))
        plain = tlm.sketch_absorb(sk, values, mask)
        for f in ("q", "n", "npd", "buf", "count"):
            bitwise &= torch.equal(getattr(kern, f), getattr(plain, f))
            bitwise &= torch.equal(getattr(got, f), getattr(plain, f))
        n_obs.append(int(mask.sum()))
    mid = len(p2_log) // 2
    sk, values, mask, _ = p2_log[mid]
    p2_ms = device_ms(lambda: p2.p2_absorb(sk, values, mask), iters=200)
    p2_plain_ms = device_ms(lambda: tlm.sketch_absorb(sk, values, mask), iters=3)
    hz = p2.clock_hz(DEVICE)
    n_q, n_v, n_valid = sk.q.shape[-2], values.numel(), int(mask.sum())
    p2_bytes = 5 * n_v + 4 * (4 * n_q * 5 + 6) + 4 * (3 * n_q * 5 + 6)
    p2_ops = P2_OPS_PER_UPDATE * n_q * n_valid
    out["p2"] = dict(
        absorbs=len(p2_log), bitwise_every_absorb=bitwise, observations=n_obs,
        timed_absorb=dict(index=mid, values=n_v, valid=n_valid, quantiles=n_q),
        ms=p2_ms, plain_ms=p2_plain_ms, us_per_absorb=p2_ms * 1e3,
        plain_us_per_absorb=p2_plain_ms * 1e3,
        bytes=p2_bytes, ops=p2_ops,
        bytes_ms=p2_bytes / HBM_BYTES_PER_S * 1e3, ops_ms=p2_ops / SCALAR_OPS_PER_S * 1e3,
        # the dependent chain: the kernel's walk over the valid values,
        # timed in-kernel (clock64, no launch, no global load) on this
        # absorb's data, in seconds at the clock measured by the probe
        sm_clock_hz=hz, walk_cycles=walk_cycles,
        cycles_per_update=sum(walk_cycles) / max(sum(n_obs), 1),
        chain_ms=walk_cycles[mid] / hz * 1e3)
    out["p2"]["bound_ms"] = max(out["p2"]["bytes_ms"], out["p2"]["ops_ms"], out["p2"]["chain_ms"])
    out["p2"]["bound_by"] = "bytes" if out["p2"]["bound_ms"] == out["p2"]["bytes_ms"] else "operations"
    check(len(p2_log) == len(runs["megha"].refills), "the P² log holds every megha absorb")
    check(bitwise, "P² kernel bitwise its plain version after every absorb")

    # (f) one mid-run segment under the profiler: megha's from (e), and
    # sparrow's of a 10 s run driven the same way
    by_seg["sparrow"] = _stream_by_segment("sparrow", STREAM_PROFILE_HORIZON,
                                           profile_segment=STREAM_PROFILE_SEGMENT)
    n_del = len(by_seg["sparrow"]["delays"])
    want_q = np.stack([runs["sparrow"].series[k] for k in qkeys], axis=1).astype(np.float32)
    n_seg = len(by_seg["sparrow"]["quantiles"])
    check(np.array_equal(by_seg["sparrow"]["delays"], runs["sparrow"].delays[:n_del])
          and np.array_equal(by_seg["sparrow"]["quantiles"], want_q[:n_seg], equal_nan=True),
          "sparrow stream: the driven segments are bitwise the entry point's run")
    out["profile"] = {}
    for name in ("megha", "sparrow"):
        out["profile"][name] = _segment_profile(name, by_seg[name])
        check(out["profile"][name]["device_ops_per_round"] > 0,
              f"{name} stream: the profiler saw device work")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    out["_runs"] = runs
    return out


def _np_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def _shard_arrivals(rate: float):
    return PoissonArrivals(rate=rate, job_factory=fixed_job_factory(1000, 1.0), seed=7)


def _runs_prefix_bitwise(short, long) -> bool:
    """A run cut at an earlier horizon is bitwise the first refills of the
    longer run of the same stream: delays, series, refills, and its final
    sketch estimates those of the longer run's refill at its end."""
    n, k = len(short.refills), len(short.delays)
    qk = [f"q{q}" for q in short.quantile_targets]
    return (short.refills == long.refills[:n] and np.array_equal(short.delays, long.delays[:k])
            and all(np.array_equal(short.series[key], long.series[key][:n], equal_nan=True)
                    for key in short.series)
            and np.array_equal(short.quantile_estimates,
                               np.float32([long.series[q][n - 1] for q in qk]), equal_nan=True))


def _curve(name: str, orders, use_kernel: bool = True, horizon: float = STREAM_HORIZON):
    """One sharded curve on the one-card mesh: (runs, wall, match launches,
    P² launches, peak bytes), the counts set to 0 just before the run and
    read just after it."""
    match.match_ranks_batched.launches = 0
    p2.p2_absorb.launches = 0
    _reset_peak_memory()
    t0 = time.perf_counter()
    runs = shard.sharded_steady_state(
        name, [_shard_arrivals(r) for r in SHARD_RATES], WORKERS, mesh=shard.sweep_mesh(),
        dt=DT, horizon=horizon, use_kernel=use_kernel,
        orders=orders if name == "megha" else None, **STREAM_WINDOW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (runs, wall, match.match_ranks_batched.launches, p2.p2_absorb.launches,
            torch.cuda.max_memory_allocated())


def _curve_profile(name: str, orders, want: list) -> dict:
    """(e): the curve driven segment by segment from the engine's own
    host loop (``stream._SteadyLoop``) to ``SHARD_SHORT_HORIZON`` (held
    bitwise to the first refills of the entry point's 30 s runs
    ``want``); segment
    ``SHARD_PROFILE_SEGMENT`` runs again from the same inputs under
    torch.profiler: device busy and idle share a round over the segment's
    own wall."""
    from torch.profiler import ProfilerActivity, profile

    curve = stream._SteadyLoop(
        name, [_shard_arrivals(r) for r in SHARD_RATES], WORKERS, devices=shard.sweep_mesh(),
        dt=DT, horizon=SHARD_SHORT_HORIZON, orders=orders if name == "megha" else None,
        **STREAM_WINDOW)
    seg_ms, refill_ms, prof = [], [], None
    while not curve.done:
        seg = curve.segment()
        seg_ms.append(seg["seconds"] * 1e3)
        if len(seg_ms) - 1 == SHARD_PROFILE_SEGMENT:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                again = curve.segment()
            check(np.array_equal(again["scal"], seg["scal"], equal_nan=True)
                  and torch.equal(again["state"].task_finish, seg["state"].task_finish),
                  f"{name} curve: the profiled segment repeats the timed one")
            prof = (p, again["seconds"] * 1e3)
        t0 = time.perf_counter()
        curve.refill(seg)
        refill_ms.append((time.perf_counter() - t0) * 1e3)
    runs = curve.runs()
    check(all(_runs_prefix_bitwise(a, b) for a, b in zip(runs, want)),
          f"{name} curve: the driven segments are bitwise the entry point's runs")
    p, prof_ms = prof
    busy_us, spans, by_name = _device_busy(p)
    rounds = STREAM_WINDOW["rounds_per_refill"]
    i = SHARD_PROFILE_SEGMENT
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        segment=i, segments=len(seg_ms), lanes=SHARD_LANES, rounds=rounds,
        device_busy_ms_per_round=busy_us / 1e3 / rounds,
        device_ops_per_round=len(spans) / rounds,
        segment_wall_ms=seg_ms[i], segment_wall_ms_per_round=seg_ms[i] / rounds,
        profiled_segment_wall_ms=prof_ms,
        device_idle_share=1.0 - busy_us / 1e3 / seg_ms[i],
        device_idle_share_profiled=1.0 - busy_us / 1e3 / prof_ms,
        refill_host_ms=refill_ms[i], refill_host_ms_mean=float(np.mean(refill_ms)),
        p2_kernel_ms=sum(v for k, v in by_name.items() if "p2_absorb" in k),
        top_device_ms=[[k[:90], v] for k, v in top])


def phase_shard(swp: dict, fig4: dict, strm: dict) -> dict:
    """The sharded executors at the paper's size: (a) the Fig. 2 grids of
    all five rules and megha's Fig. 4 grid on the one-card mesh, bitwise
    the sweep and fig4 phases' grids; (b) the indivisible 15-point grid on
    a mesh naming the card twice, bitwise the one-entry mesh's; (c) every
    rule's 4-lane curve, each lane bitwise its serial run; (d) megha's
    curve with the plain versions, bitwise; (e) one segment of megha's and
    sparrow's curve under the profiler."""
    t_phase = time.perf_counter()
    mesh = shard.sweep_mesh()
    out = dict(phase="shard", mesh=[str(d) for d in mesh], rates=list(SHARD_RATES),
               loads=[_shard_arrivals(r).offered_load(WORKERS) for r in SHARD_RATES],
               horizon=STREAM_HORIZON, workers=WORKERS, megha_workers=GRID_WORKERS,
               **STREAM_WINDOW)
    check(len(mesh) == 1, "sweep_mesh() is the one card")

    # (a) the paper-scale grids on the one-card mesh
    out["fig2"] = {}
    for name in SWEEP_RULES:
        match.match_ranks_batched.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = shard.sharded_fig2_sweep(name, mesh=mesh, device=DEVICE, **SWEEP_FULL)
        wall = time.perf_counter() - t0
        launches = match.match_ranks_batched.launches
        want = swp["rules"][name]
        same = all(_np_equal(res[k].reshape(-1), v) for k, v in want["summary"].items())
        out["fig2"][name] = dict(wall_s=wall, serial_wall_s=want["wall_s"],
                                 kernel_launches=launches,
                                 serial_launches=want["kernel_launches"],
                                 n_devices=int(res["n_devices"]), bitwise_serial=same)
        check(same, f"shard {name}: the sharded Fig. 2 grid is bitwise the sweep phase's")
        check(launches == want["kernel_launches"],
              f"shard {name}: the sharded grid launches as the serial grid does")
    match.match_ranks_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = shard.sharded_fig4_sweep("megha", mesh=mesh, device=DEVICE, **FIG4_FULL)
    wall = time.perf_counter() - t0
    want = fig4["_summaries"]["megha"]
    same = all(_np_equal(res[k], v) for k, v in want.items())
    out["fig4_megha"] = dict(wall_s=wall, serial_wall_s=fig4["rules"]["megha"]["wall_s"],
                             kernel_launches=match.match_ranks_batched.launches,
                             serial_launches=fig4["rules"]["megha"]["kernel_launches"],
                             bitwise_serial=same)
    check(same, "shard megha: the sharded Fig. 4 grid is bitwise the fig4 phase's")
    check(out["fig4_megha"]["kernel_launches"] == out["fig4_megha"]["serial_launches"],
          "shard megha: the sharded Fig. 4 grid launches as the serial grid does")

    # (b) 15 points on a mesh naming the card twice (pads to 16)
    out["padded"] = {}
    twice = shard.Mesh((mesh[0], mesh[0]))
    for name in ("megha", "sparrow"):
        one = shard.sharded_fig2_sweep(name, mesh=mesh, **SHARD_PAD_GRID)
        two = shard.sharded_fig2_sweep(name, mesh=twice, **SHARD_PAD_GRID)
        same = all(_np_equal(two[k], one[k]) for k in one if k != "n_devices")
        out["padded"][name] = dict(points=15, entries=len(twice), bitwise=same,
                                   shape=list(two["p50"].shape))
        check(same and two["p50"].shape == (5, 3),
              f"shard {name}: the 15-point grid on two entries is bitwise one entry's")

    # (c) every rule's 4-lane curve against its serial runs; (d) megha plain
    cfg = SimxConfig(num_workers=GRID_WORKERS, dt=DT)
    orders = simx_megha.gm_orders(torch.Generator().manual_seed(0), cfg)
    out["curve"] = {}
    curves = {}
    for name in STREAM_RULES:
        horizon = SHARD_CURVE_HORIZON.get(name, STREAM_HORIZON)
        serial, walls = [], []
        for rate in SHARD_RATES:
            if rate == STREAM_RATE and horizon == STREAM_HORIZON:
                serial.append(strm["_runs"][name])
                walls.append(strm["rules"][name]["wall_s"])
                continue
            run, wall, _, _, _ = _stream_run(name, _shard_arrivals(rate), horizon=horizon,
                                             orders=orders if name == "megha" else None)
            serial.append(run)
            walls.append(wall)
        runs, wall, launches, p2_launches, peak = _curve(name, orders, horizon=horizon)
        curves[name] = runs
        segments = max(len(r.refills) for r in runs)
        base = STREAM_PER_ROUND[name] * segments * STREAM_WINDOW["rounds_per_refill"]
        borrow = [r.borrow_rounds for r in runs]
        bitwise = [_runs_bitwise(a, b) and all(
            getattr(a, f) == getattr(b, f) for f in (
                "rounds", "tasks_completed", "lost", "messages", "probes", "end_time",
                "state_bytes", "borrow_rounds")) for a, b in zip(runs, serial)]
        tasks = sum(r.tasks_completed for r in runs)
        out["curve"][name] = dict(
            workers=runs[0].cfg.num_workers, horizon=horizon, wall_s=wall,
            segment_s=runs[0].segment_seconds,
            refill_s=sum(r.refill_seconds for r in runs),
            refill_share=sum(r.refill_seconds for r in runs) / wall,
            segments=segments, tasks_completed=tasks, tasks_per_wall_s=tasks / wall,
            serial_walls_s=walls, wall_over_serial_sum=wall / sum(walls),
            kernel_launches=launches, base_launches=base, borrow_rounds_by_lane=borrow,
            p2_launches=p2_launches,
            p50=[r.quantile(0.5) for r in runs], p99=[r.quantile(0.99) for r in runs],
            p999=[r.quantile(0.999) for r in runs],
            admission_lag_max=[float(r.series["admission_lag"].max()) for r in runs],
            mean_utilization=[r.mean_utilization for r in runs],
            state_bytes=[r.state_bytes for r in runs], max_memory_allocated=peak,
            lost=[r.lost for r in runs], bitwise_serial=bitwise)
        check(all(bitwise), f"shard {name}: every lane of the curve is bitwise its serial run")
        check(all(r.end_time >= horizon for r in runs),
              f"shard {name}: every lane reached the horizon")
        check(all(r.lost == 0 for r in runs), f"shard {name}: nothing lost")
        check(p2_launches == segments, f"shard {name}: one P² launch a segment for all lanes")
        check(base + max(borrow) <= launches <= base + sum(borrow),
              f"shard {name}: match launches = segments' rounds x "
              f"{STREAM_PER_ROUND[name]} + the rounds any lane borrowed in")
    runs, wall, launches, p2_launches, _ = _curve("megha", orders, use_kernel=False,
                                                  horizon=SHARD_SHORT_HORIZON)
    same = all(_runs_prefix_bitwise(a, b) for a, b in zip(runs, curves["megha"]))
    out["plain_megha"] = dict(wall_s=wall, horizon=SHARD_SHORT_HORIZON,
                              segments=len(runs[0].refills), bitwise_kernel=same,
                              match_launches=launches, p2_launches=p2_launches)
    check(same, "shard megha: the plain curve is bitwise the kernel curve")
    check(launches == 0 and p2_launches == 0, "shard megha: the plain curve launches nothing")

    # (e) one segment of megha's and sparrow's curve under the profiler
    out["profile"] = {name: _curve_profile(name, orders, curves[name])
                      for name in ("megha", "sparrow")}
    for name, r in out["profile"].items():
        check(r["device_ops_per_round"] > 0, f"{name} curve: the profiler saw device work")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_eagle_long() -> dict:
    """Eagle's SSS and central long match, which the synthetic trace never
    reaches: ``google_like_trace()`` at 13,000 workers until 12.5 s, first
    through ``run_simulation`` (whose launches count), then kernel and
    plain runs of ``simulate_workload`` whose final states must agree."""
    wl = google_like_trace()
    kw = dict(until=EAGLE_LONG_UNTIL, dt=DT, device=DEVICE)
    match.match_ranks_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = run_simulation("eagle", wl, EAGLE_LONG_WORKERS, backend="simx", **kw)
    entry_wall = time.perf_counter() - t0
    launches = match.match_ranks_batched.launches
    runs, walls, run_launches = {}, {}, {}
    for use_kernel in (True, False):
        before = match.match_ranks_batched.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[use_kernel] = simulate_workload("eagle", wl, EAGLE_LONG_WORKERS,
                                             use_kernel=use_kernel, **kw)
        torch.cuda.synchronize()
        walls[use_kernel] = time.perf_counter() - t0
        run_launches[use_kernel] = match.match_ranks_batched.launches - before
    run = runs[True]
    s, tasks = run.state, run.tasks
    rounds = int(s.rnd)
    long_task = (tasks.job_est >= run.cfg.long_threshold)[tasks.job.long()]
    summary = m.summary()
    out = dict(
        phase="eagle_long", entry="run_simulation", workers=EAGLE_LONG_WORKERS,
        jobs=len(wl.jobs), tasks=wl.num_tasks,
        long_jobs=int((tasks.job_est >= run.cfg.long_threshold).sum()),
        long_tasks=int(long_task.sum()), until=EAGLE_LONG_UNTIL, rounds=rounds,
        last_arrival_s=float(tasks.job_submit.max()), longest_task_s=float(tasks.duration.max()),
        pick_shape=list(s.resq.shape), central_shape=[1, EAGLE_LONG_WORKERS],
        queue_slots=int(s.resq.shape[-1]),
        completed=completed(m), long_tasks_launched=int(
            (~torch.isinf(s.task_finish) & long_task).sum()),
        long_head=int(s.long_head), sss_rejections=int(s.probes) - int(s.probe_head),
        probes=int(s.probes), probe_head=int(s.probe_head),
        res_overflow=int(s.res_overflow), probe_lag=int(s.probe_lag),
        p50_delay=summary["all_median_delay"], p95_delay=summary["all_p95_delay"],
        kernel_launches=launches, run_launches=run_launches[True],
        plain_run_launches=run_launches[False],
        kernel_and_plain_bitwise=states_equal(runs[True].state, runs[False].state),
        entry_wall_s=entry_wall, wall_s=walls[True], plain_wall_s=walls[False],
        ms_per_round=walls[True] / rounds * 1e3,
    )
    check(rounds == int(round(EAGLE_LONG_UNTIL / DT)), "eagle_long runs to its time cap")
    check(launches == 2 * rounds == run_launches[True],
          "eagle_long: the pick and the central match launch once a round each")
    check(run_launches[False] == 0, "eagle_long: the plain run launches no kernel")
    check(out["kernel_and_plain_bitwise"], "eagle_long: kernel and plain states bitwise equal")
    check(out["long_tasks_launched"] > 0, "eagle_long: the central FIFO launched long tasks")
    check(out["sss_rejections"] > 0, "eagle_long: SSS rejected probes")
    emit(out)
    return out


def phase_cpu_parity() -> dict:
    wl = synthetic_trace(num_jobs=24, tasks_per_job=128, load=0.8,
                         num_workers=1024, seed=1)
    out = dict(phase="cpu_parity")
    for name in ("megha", "oracle"):
        runs = {
            dev: simulate_workload(name, wl, 1024, dt=0.02, device=dev)
            for dev in ("cpu", DEVICE)
        }
        out[name] = dict(
            bitwise_equal=states_equal(runs["cpu"].state, runs[DEVICE].state),
            rounds=int(runs[DEVICE].state.rnd),
            borrow_rounds=runs[DEVICE].borrow_rounds,
            completed=runs[DEVICE].tasks_completed, tasks=wl.num_tasks,
        )
        check(out[name]["bitwise_equal"], f"{name}: CPU and card states bitwise equal")
        check(out[name]["completed"] == wl.num_tasks, f"{name}: completes")
    # the serving engine at 4 frontends x 4 pods x 64 slots, same seed
    engines = {}
    for dev in ("cpu", DEVICE):
        eng = MeghaServeEngine(num_frontends=4, num_pods=4, slots_per_pod=64, seed=0,
                               device=dev)
        rng = np.random.default_rng(0)
        eng.submit([Request(i, gen_len=int(rng.integers(1, 20))) for i in range(1500)])
        eng.run_until_drained()
        engines[dev] = eng
    out["serve"] = dict(
        bitwise_equal=_engine_states_equal(_engine_state(engines["cpu"]),
                                           _engine_state(engines[DEVICE])),
        ticks=engines[DEVICE].stats.ticks, gm_rounds=engines[DEVICE].gm_rounds,
        summary=engines[DEVICE].stats.summary(),
    )
    check(out["serve"]["bitwise_equal"], "serve: CPU and card engines bitwise equal")
    check(out["serve"]["summary"]["completed"] == 1500, "serve: completes")
    # eagle with long jobs (SSS and the central match) at 200 workers
    wl = google_like_trace(num_jobs=60, total_tasks=1500, num_workers=200, seed=2)
    runs = {dev: simulate_workload("eagle", wl, 200, until=20.0, device=dev)
            for dev in ("cpu", DEVICE)}
    st = runs[DEVICE].state
    out["eagle_long"] = dict(
        bitwise_equal=states_equal(runs["cpu"].state, st), rounds=int(st.rnd),
        sss_rejections=int(st.probes) - int(st.probe_head), long_head=int(st.long_head))
    check(out["eagle_long"]["bitwise_equal"], "eagle with long jobs: CPU and card bitwise equal")
    check(out["eagle_long"]["sss_rejections"] > 0 and out["eagle_long"]["long_head"] > 0,
          "eagle with long jobs: SSS and the central match ran")
    # the sweep grids at bench_simx.py's default size, B = 4
    out["sweep"] = {}
    for name in SWEEP_RULES:
        states = {}
        for dev in ("cpu", DEVICE):
            plan = sweep.fig2_plan(name, device=dev, **SWEEP_SMALL)
            states[dev], tasks, _ = sweep.grid_state(
                name, plan.cfg, plan.tasks, plan.submit_grid, plan.job_submit_grid,
                plan.seeds, plan.num_rounds)
        out["sweep"][name] = dict(
            bitwise_equal=states_equal(states["cpu"], states[DEVICE]),
            rounds=plan.num_rounds,
            tasks_done=sweep.point_summary(states[DEVICE], tasks)["tasks_done"].tolist())
        check(out["sweep"][name]["bitwise_equal"], f"{name} grid: CPU and card bitwise equal")
        check(all(v == tasks.num_tasks for v in out["sweep"][name]["tasks_done"]),
              f"{name} grid: completes")
    emit(out)
    return out


def _single_row_cases(gen: torch.Generator):
    """Rows of the single-row sweep: (w, dtype, avail on the card)."""
    for w in SWEEP_WIDTHS:
        for dtype in SWEEP_DTYPES:
            yield w, dtype, (torch.rand((w,), generator=gen) < 0.4).to(dtype).to(DEVICE)


def phase_kernel_single(gen: torch.Generator) -> dict:
    """The single-row kernel: both entry points against their plain versions
    over the sweep, then timed at the serving and SDPS shapes."""
    cases, worst = 0, 0
    for w, dtype, avail in _single_row_cases(gen):
        for n in (0, 1, w // 2, w, w + 7):
            # n by value, then from the device
            for count in (n, torch.tensor(n, dtype=torch.int32, device=DEVICE)):
                got = match.match_ranks(avail, count)
                want = ref.match_ranks_ref(avail, n)
                worst = max(worst, int((got - want).abs().max()))
                check(torch.equal(got, want), f"match_ranks == plain at w={w} {dtype} n={n}")
                cases += 1
                for max_tasks in (MAX_TASKS, w):
                    a, p = match.match_tasks(avail, count, max_tasks)
                    wa, wp = ref.match_tasks_ref(avail, min(n, max_tasks), max_tasks)
                    torch.cuda.synchronize()
                    if a.numel():
                        worst = max(worst, int((a - wa).abs().max()))
                    worst = max(worst, abs(int(p) - int(wp)))
                    check(torch.equal(a, wa) and torch.equal(p, wp),
                          f"match_tasks == plain at w={w} {dtype} n={n} max_tasks={max_tasks}")
                    cases += 1
    emit(dict(phase="kernel_single", check="sweep", cases=cases, max_abs_err=worst,
              widths=list(SWEEP_WIDTHS), dtypes=[str(d) for d in SWEEP_DTYPES],
              n=["0", "1", "w/2", "w", "w+7"], max_tasks=[MAX_TASKS, "w"]))

    rows = []
    for caller, w in SINGLE_SHAPES:
        # bool views as gm_round passes them, half the lanes free, and the
        # serving / SDPS batch n = max_tasks = 512
        avail = (torch.rand((w,), generator=gen) < 0.5).to(DEVICE)
        n = MAX_TASKS
        a, p = match.match_tasks(avail, n, MAX_TASKS)
        wa, wp = ops.match_tasks(avail, n, MAX_TASKS, use_kernel=False)
        r_got, r_want = match.match_ranks(avail, n), ref.match_ranks_ref(avail, n)
        err = max(int((a - wa).abs().max()), abs(int(p) - int(wp)),
                  int((r_got - r_want).abs().max()))
        check(err == 0, f"single-row kernel == plain at {caller} [{w}]")
        # bytes the fused match must move: the lanes up to the n-th free one
        # (no later lane can change the result), the assignment and the count
        need_lanes = int(torch.nonzero(avail)[n - 1]) + 1 if int(wp) == n else w
        tasks_bytes = need_lanes + 4 * MAX_TASKS + 4
        ranks_bytes = w * (avail.element_size() + 4)
        r = dict(
            phase="kernel_single", caller=caller, shape=[w], dtype="bool", n=n,
            max_tasks=MAX_TASKS, max_abs_err=err,
            ms=device_ms(lambda: match.match_tasks(avail, n, MAX_TASKS)),
            plain_ms=device_ms(lambda: ops.match_tasks(avail, n, MAX_TASKS, use_kernel=False)),
            library_ms=device_ms(lambda: torch.cumsum(avail, dim=0, dtype=torch.int32)),
            host_us=host_us(lambda: match.match_tasks(avail, n, MAX_TASKS)),
            plain_host_us=host_us(
                lambda: ops.match_tasks(avail, n, MAX_TASKS, use_kernel=False)),
            bytes=tasks_bytes, bytes_if_every_lane_read=w + 4 * MAX_TASKS + 4,
            bound_ms=max(tasks_bytes / HBM_BYTES_PER_S,
                         need_lanes / SCALAR_OPS_PER_S) * 1e3,
            bound_by="bytes",
            ranks_ms=device_ms(lambda: match.match_ranks(avail, n)),
            ranks_plain_ms=device_ms(lambda: ref.match_ranks_ref(avail, n)),
            ranks_host_us=host_us(lambda: match.match_ranks(avail, n)),
            ranks_bytes=ranks_bytes,
            ranks_bound_ms=max(ranks_bytes / HBM_BYTES_PER_S, w / SCALAR_OPS_PER_S) * 1e3,
        )
        emit(r)
        rows.append(r)
    return dict(sweep_cases=cases, sweep_err=worst, rows=rows)


def _serve_engine_run(use_kernel: bool, sync_debug: bool = False):
    """One serving run at the full fleet: Poisson(3000) arrivals a tick,
    lengths 1 + Poisson(12), until 200,000 requests are in, then a drain.
    Returns (engine, wall seconds, host syncs counted by torch or None)."""
    eng = MeghaServeEngine(**SERVE, use_kernel=use_kernel, device=DEVICE)
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    with (sentinels.count_syncs() if sync_debug else contextlib.nullcontext()) as counter:
        t0 = time.perf_counter()
        rid = 0
        while rid < SERVE_REQUESTS:
            n = min(int(rng.poisson(SERVE_ARRIVAL)), SERVE_REQUESTS - rid)
            eng.submit([Request(rid + i, gen_len=1 + int(rng.poisson(SERVE_MEAN_GEN)))
                        for i in range(n)])
            rid += n
            eng.tick()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return eng, wall, counter.count if sync_debug else None


def _engine_state(eng) -> dict:
    return dict(
        truth=eng.truth.cpu(), views=torch.stack(eng.views).cpu(),
        running=sorted((s, r.rid) for s, r in eng.running.items()),
        stats=eng.stats, gm_rounds=eng.gm_rounds,
    )


def _engine_states_equal(a: dict, b: dict) -> bool:
    return (torch.equal(a["truth"], b["truth"]) and torch.equal(a["views"], b["views"])
            and a["running"] == b["running"] and a["stats"] == b["stats"]
            and a["gm_rounds"] == b["gm_rounds"])


def phase_serve() -> dict:
    """The serving path: the kernel engine's run is the one whose launches
    count; then kernel and plain engines in turns (kernel, plain, plain,
    kernel, kernel, plain): identical stats and final state; then one run
    under torch's sync-debug mode for the host syncs."""
    match.match_tasks.launches = 0
    match.match_ranks.launches = 0
    match.match_ranks_batched.launches = 0
    _reset_peak_memory()
    eng, wall, _ = _serve_engine_run(True)
    launches = dict(match_tasks=match.match_tasks.launches,
                    match_ranks=match.match_ranks.launches,
                    match_ranks_batched=match.match_ranks_batched.launches)
    mem = torch.cuda.max_memory_allocated()
    ref_state = _engine_state(eng)
    s = eng.stats.summary()
    check(s["completed"] == SERVE_REQUESTS == s["placed"],
          "the engine completes every submitted request")
    check(launches["match_tasks"] == eng.gm_rounds > 0,
          "gm_round calls == single-row kernel launches")
    check(launches["match_ranks_batched"] == 0, "the serving path runs no batched match")

    walls = {True: [], False: []}
    equal = True
    for use_kernel in (True, False, False, True, True, False):
        before = match.match_tasks.launches
        e, w, _ = _serve_engine_run(use_kernel)
        walls[use_kernel].append(w)
        n_launch = match.match_tasks.launches - before
        check(n_launch == (e.gm_rounds if use_kernel else 0),
              "kernel engines launch once per round, plain engines never")
        equal = equal and _engine_states_equal(ref_state, _engine_state(e))
    check(equal, "kernel and plain engines: identical stats and final state")
    sync_eng, _, syncs = _serve_engine_run(True, sync_debug=True)
    check(syncs >= 2 * sync_eng.gm_rounds, "sync-debug mode counted the host reads")

    out = dict(
        phase="serve", entry="MeghaServeEngine.tick", slots=eng.w, **SERVE,
        requests=SERVE_REQUESTS, arrival_per_tick=SERVE_ARRIVAL, mean_gen=SERVE_MEAN_GEN,
        submitted=SERVE_REQUESTS, completed=s["completed"], summary=s,
        ticks=eng.stats.ticks, gm_rounds=eng.gm_rounds,
        gm_rounds_per_tick=eng.gm_rounds / eng.stats.ticks, kernel_launches=launches,
        wall_s=wall, requests_per_wall_s=SERVE_REQUESTS / wall,
        walls_s=walls[True], plain_walls_s=walls[False],
        median_wall_s=float(np.median(walls[True])),
        plain_median_wall_s=float(np.median(walls[False])),
        kernel_and_plain_identical=equal,
        host_syncs=syncs, host_syncs_per_tick=syncs / sync_eng.stats.ticks,
        host_syncs_per_gm_round=syncs / sync_eng.gm_rounds,
        max_memory_allocated=mem,
    )
    emit(out)
    return out


def _host_op_split(prof) -> tuple[float, int, list]:
    """Host µs inside top-level torch ops (dispatch, launches and the waits
    of host reads), their number, and the top ops by that time, from a
    torch.profiler run; the rest of the wall is Python outside torch."""
    from torch.autograd import DeviceType

    total, count, by_name = 0.0, 0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or e.cpu_parent is not None:
            continue
        us = e.time_range.end - e.time_range.start
        total += us
        count += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    return total, count, sorted(by_name.items(), key=lambda kv: -kv[1])[:8]


def _serve_ticks(eng, rng, ticks: int) -> None:
    for _ in range(ticks):
        n = int(rng.poisson(SERVE_ARRIVAL))
        eng.submit([Request(i, gen_len=1 + int(rng.poisson(SERVE_MEAN_GEN))) for i in range(n)])
        eng.tick()


def phase_serve_profile() -> dict:
    """Where a steady serving tick's time goes: 30 warm ticks, then ticks
    30-40 timed without the profiler and, on an identical engine, under
    torch.profiler (device busy, host time in torch ops); then five SDPS
    loop iterations at 49,984 workers under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    out = dict(phase="serve_profile", ticks=[30, 40])
    walls = []
    for profiled in (False, True):
        eng = MeghaServeEngine(**SERVE, device=DEVICE)
        rng = np.random.default_rng(1)
        _serve_ticks(eng, rng, 30)
        torch.cuda.synchronize()
        rounds0 = eng.gm_rounds
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _serve_ticks(eng, rng, 10)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            _serve_ticks(eng, rng, 10)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rounds = eng.gm_rounds - rounds0
    busy_us, spans, by_name = _device_busy(prof)
    host_us, host_ops, top_host = _host_op_split(prof)
    out.update(
        gm_rounds=rounds, wall_ms_per_tick=walls[0] * 1e2,
        profiled_wall_ms_per_tick=prof_wall * 1e2,
        device_busy_ms_per_tick=busy_us / 1e4,
        device_idle_share=1.0 - busy_us / 1e6 / walls[0],
        device_ops_per_tick=len(spans) / 10,
        torch_op_host_ms_per_tick=host_us / 1e4, torch_ops_per_tick=host_ops / 10,
        torch_op_host_share_profiled=host_us / 1e6 / prof_wall,
        top_host_ms=[[k[:60], v / 1e3] for k, v in top_host],
        top_device_ms=[[k[:90], v] for k, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:6]],
    )
    check(out["device_ops_per_tick"] > 0, "the profiler saw the serving ticks' device work")

    workers = SDPS_WORKERS[-1] // 64 * 64
    orders = FP.make_orders(workers, 8, 8, seed=0, device=DEVICE)
    truth = torch.ones((workers,), dtype=torch.bool, device=DEVICE)
    FP.gm_round(truth, truth, orders[0], MAX_TASKS, max_tasks=MAX_TASKS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            FP.gm_round(truth, truth, orders[i], MAX_TASKS, max_tasks=MAX_TASKS)
            FP.gm_round(truth, truth, orders[i], 0, max_tasks=MAX_TASKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, spans, _ = _device_busy(prof)
    host_us, host_ops, top_host = _host_op_split(prof)
    out["sdps_gm_round"] = dict(
        workers=workers, rounds=10, profiled_wall_ms_per_round=wall * 1e2,
        device_busy_ms_per_round=busy_us / 1e4, device_ops_per_round=len(spans) / 10,
        torch_op_host_ms_per_round=host_us / 1e4, torch_ops_per_round=host_ops / 10,
        top_host_ms=[[k[:60], v / 1e3] for k, v in top_host],
    )
    emit(out)
    return out


def _fastpath_sdps(workers: int, use_kernel: bool, rounds: int = 20) -> float:
    """``benchmarks/bench_sdps.py::_fastpath_sdps`` on the port: rounds of
    512 decisions on an all-free fleet, ending in a synchronize.  Both
    rounds of the loop take ``use_kernel`` (the reference's second, n = 0,
    round takes the default path)."""
    workers = (workers // 64) * 64  # divisible into the 8x8 partition grid
    orders = FP.make_orders(workers, 8, 8, seed=0, device=DEVICE)
    truth = torch.ones((workers,), dtype=torch.bool, device=DEVICE)
    view = torch.ones((workers,), dtype=torch.bool, device=DEVICE)
    n = MAX_TASKS
    r = FP.gm_round(truth, view, orders[0], n, max_tasks=MAX_TASKS, use_kernel=use_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decisions = 0
    for i in range(rounds):
        r = FP.gm_round(truth, view, orders[i % 8], n, max_tasks=MAX_TASKS,
                        use_kernel=use_kernel)
        decisions += n
        # free everything again so the pool never empties
        truth = FP.gm_round(truth, view, orders[i % 8], 0, max_tasks=MAX_TASKS,
                            use_kernel=use_kernel).truth
    torch.cuda.synchronize()
    check(int((r.workers >= 0).sum()) == n, "every SDPS round places its batch")
    return decisions / (time.perf_counter() - t0)


def phase_sdps() -> dict:
    out = dict(phase="sdps", rounds=20, batch=MAX_TASKS, fastpath=[])
    match.match_tasks.launches = 0
    launches = 0
    for workers in SDPS_WORKERS:
        sdps = {True: [], False: []}
        for use_kernel in (True, False, False, True, True, False):
            before = match.match_tasks.launches
            sdps[use_kernel].append(_fastpath_sdps(workers, use_kernel))
            n_launch = match.match_tasks.launches - before
            check(n_launch == (41 if use_kernel else 0),
                  "SDPS: one launch per gm_round with the kernel, none without")
            launches += n_launch
        out["fastpath"].append(dict(
            workers=(workers // 64) * 64, decisions_per_s=sdps[True],
            plain_decisions_per_s=sdps[False],
            median_decisions_per_s=float(np.median(sdps[True])),
            plain_median_decisions_per_s=float(np.median(sdps[False])),
        ))
    out["kernel_launches"] = launches
    wl = synthetic_trace(num_jobs=40, tasks_per_job=200, load=0.7, num_workers=2048)
    t0 = time.perf_counter()
    m = run_simulation("megha", wl, num_workers=2048)
    wall = time.perf_counter() - t0
    check(completed(m) == wl.num_tasks, "the event backend completes every task")
    out["event_sim"] = dict(backend="events", workers=2048, tasks=len(m.tasks),
                            wall_s=wall, tasks_per_wall_s=len(m.tasks) / wall,
                            inconsistencies=m.inconsistencies,
                            repartitions=m.repartitions, messages=m.messages)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase lm_serve: real-decode serving at full width
# ---------------------------------------------------------------------------


def _lm_submit(eng, rng, rid: int, requests: int) -> int:
    """One tick's Poisson arrivals of the launcher's loop; the next rid."""
    n = min(int(rng.poisson(LM_ARRIVAL)), requests - rid)
    eng.submit([Request(rid + i, gen_len=1 + int(rng.poisson(LM_MEAN_GEN)))
                for i in range(n)])
    return rid + n


def _lm_serve_loop(runner: ModelRunner, requests: int) -> dict:
    """``launch/serve.py``'s loop with ``--real-decode``: Poisson arrivals
    from the numpy seed, an engine tick, then a decode tick.  Each decode
    tick is bracketed by CUDA events and its host syncs counted, and then
    the host waits for the card, so that the engine's host reads do not
    absorb the decode's device time in the wall split.

    As in the reference, the decode does not follow the placement: every
    lane decodes on every tick.  The lanes that hold a request in that tick
    (the runner's pod, slots 0 to lanes - 1: those running after the
    engine's tick and those it completed) are counted on the host."""
    eng = MeghaServeEngine(**LM_SERVE, device=DEVICE)
    rng = np.random.default_rng(0)
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    events, syncs, engine_s, decode_s, occupied = [], 0, 0.0, 0.0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = 0
    while rid < requests:
        rid = _lm_submit(eng, rng, rid, requests)
        t1 = time.perf_counter()
        done = eng.tick()
        t2 = time.perf_counter()
        decoding = runner.pos < runner.max_len
        if decoding:
            occupied += sum(s < runner.slots for s in eng.running) \
                + sum(r.slot < runner.slots for r in done)
        if decoding:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        with sentinels.count_syncs() as c:
            runner.tick()
        syncs += c.count
        if decoding:
            ev[1].record()
            events.append(ev)
            finite &= torch.isfinite(runner.logits).all()
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        engine_s += t2 - t1
        decode_s += t3 - t2
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in events]
    return dict(eng=eng, stats=stats, wall=wall, engine_s=engine_s, decode_s=decode_s,
                syncs=syncs, step_ms=step_ms, finite=bool(finite),
                occupied_lane_steps=occupied)


def _lm_plain_engine(requests: int) -> MeghaServeEngine:
    """The loop's engine alone on the plain match (the decode does not touch
    the engine): the same arrivals from numpy seed 0, then the drain."""
    eng = MeghaServeEngine(**LM_SERVE, use_kernel=False, device=DEVICE)
    rng = np.random.default_rng(0)
    rid = 0
    while rid < requests:
        rid = _lm_submit(eng, rng, rid, requests)
        eng.tick()
    eng.run_until_drained()
    return eng


def _lm_step_ops(cfg, b: int, t: int) -> tuple[int, int]:
    """(bf16 tensor-core operations, fp32 operations) of the products of one
    decode step of ``b`` lanes against a ``t``-token cache, for every
    family: the bf16 products (projections, MLPs, the probabilities by the
    values or latents, the MoE's einsum dispatch and combine and every
    expert's capacity slots, which that dispatch computes whatever they
    hold, the SSM's projections and its conv window's product), and the fp32
    products (the attention and latent scores, the router, the SSM state's
    read-out, the unembedding).  These are the products ``FlopCounterMode``
    counts (phase dryrun (c) holds the two counts equal); the elementwise
    work (the SSM state's update, norms, softmax) is not in them."""
    d = cfg.d_model

    def mlp(f):
        return 2 * b * d * f * (3 if cfg.gated_mlp else 2), 0

    def gqa():
        hd = cfg.head_dim_eff
        scores = 2 * b * cfg.num_heads * t * hd
        proj = 2 * b * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd \
            + 2 * b * cfg.num_heads * hd * d
        return proj + scores, scores

    def mla():
        m, h = cfg.mla, cfg.num_heads
        r, p, n, v = m.kv_lora_rank, m.qk_rope_head_dim, m.qk_nope_head_dim, m.v_head_dim
        bf = 2 * b * (d * (r + p) + d * h * (n + p) + h * n * r + h * t * r + h * r * v
                      + h * v * d)
        return bf, 2 * b * h * t * (r + p)

    def moe():
        m = cfg.moe
        gs = min(m.group_size, b)
        cap = max(1, math.ceil(gs * m.top_k * m.capacity_factor / m.num_experts))
        slots = (b // gs) * m.num_experts * cap
        bf = 2 * 2 * slots * gs * d + 3 * 2 * slots * d * m.expert_d_ff
        bf += mlp(m.shared_experts * m.expert_d_ff)[0] + (mlp(cfg.d_ff)[0]
                                                          if m.dense_parallel else 0)
        return bf, 2 * b * d * m.num_experts

    def ssm():
        s = cfg.ssm
        inner = s.expand * d
        heads, gn = inner // s.headdim, s.ngroups * s.d_state
        bf = 2 * b * d * (2 * inner + 2 * gn + heads) + 2 * b * s.d_conv * (inner + 2 * gn) \
            + 2 * b * inner * d
        return bf, 2 * b * heads * s.headdim * s.d_state

    def add(*parts):
        return tuple(sum(x) for x in zip(*parts))

    if cfg.family == "ssm":
        layers = [ssm()] * cfg.num_layers
    elif cfg.family == "hybrid":
        groups, per, tail = lm_model.hybrid_layout(cfg)
        layers = [ssm()] * (groups * per + tail) + [add(gqa(), mlp(cfg.d_ff))] * groups
    else:
        nd = cfg.moe.first_k_dense if cfg.moe else 0
        attn = mla() if cfg.mla else gqa()
        ffn = moe() if cfg.moe else mlp(cfg.d_ff)
        layers = [add(attn, mlp(cfg.d_ff or cfg.moe.expert_d_ff))] * nd \
            + [add(attn, ffn)] * (cfg.num_layers - nd)
    bf16, fp32 = add(*layers)
    return bf16, fp32 + 2 * b * d * cfg.padded_vocab


def _lm_step_bound(runner: ModelRunner) -> dict:
    """The least time a decode step of ``runner`` can take on the card: the
    bytes it must move (the compute-dtype weights it reads, every cache it
    attends over or updates, the fp32 logits it writes) over the data
    sheet's HBM rate, against its operations (``_lm_step_ops``: the bf16
    products at the tensor cores' bf16 peak, the fp32 work at the fp32
    peak)."""
    cfg, b = runner.cfg, runner.slots
    weights = sum(x.numel() * x.element_size() for x in tree_leaves(runner.weights))
    cache = sum(x.numel() * x.element_size() for x in runner.cache.values())
    logits = b * cfg.padded_vocab * 4
    bf16_ops, fp32_ops = _lm_step_ops(cfg, b, lm_decode.cache_len(cfg, runner.max_len))
    bytes_ms = (weights + cache + logits) / HBM_BYTES_PER_S * 1e3
    ops_ms = (bf16_ops / BF16_OPS_PER_S + fp32_ops / SCALAR_OPS_PER_S) * 1e3
    return dict(weight_bytes=weights, cache_bytes=cache, logit_bytes=logits,
                bf16_ops=bf16_ops, fp32_ops=fp32_ops,
                bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                hbm_rate="data sheet, 3.35 TB/s")


def _lm_profile(runner: ModelRunner, pos: int, n: int = LM_PROFILE_STEPS) -> dict:
    """(b): ``n`` decode steps from ``pos`` under torch.profiler (two warm
    steps first), and the same steps timed without it."""
    from torch.profiler import ProfilerActivity, profile

    def steps(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            runner.tick()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / k

    runner.pos = pos
    steps(2)
    wall_ms = steps(n)
    runner.pos = pos
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = steps(n)
    busy_us, spans, by_name = _device_busy(prof)
    busy_ms = busy_us / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # the torch ops that launched that device time (self time: a kernel
    # counts for the op that launched it), and their calls a step
    ops = sorted(((e.key, e.self_device_time_total / 1e3 / n,
                   e.count / n) for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda r: -r[1])[:10]
    bound = _lm_step_bound(runner)
    return dict(
        positions=[pos, pos + n],
        wall_ms_per_step=wall_ms, profiled_wall_ms_per_step=prof_ms,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1.0 - busy_ms / wall_ms,
        device_idle_share_profiled=1.0 - busy_ms / prof_ms,
        device_ops_per_step=len(spans) / n,
        top_device_ms_per_step=[[k[:90], v / n] for k, v in top],
        top_ops_device_ms_and_calls_per_step=[[k, ms, c] for k, ms, c in ops],
        **bound, busy_over_bound=busy_ms / bound["bound_ms"],
    )


def _lm_decode_vs_forward(arch: str) -> tuple[dict, dict]:
    """(c): the full-width model in fp32 compute, weights drawn on the card
    from a seeded generator: each decode step's logits against the
    teacher-forced forward's at that position.  Returns the result and the
    model's parameters, for (d)."""
    cfg = dataclasses.replace(lm_config(arch), compute_dtype=torch.float32)
    t0 = time.perf_counter()
    lm = lm_model.LanguageModel(cfg, generator=torch.Generator(device=DEVICE).manual_seed(1),
                                device=DEVICE)
    params = lm.tree()
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (LM_CHECK_BATCH, LM_CHECK_STEPS), generator=gen,
                         dtype=torch.int32).to(DEVICE)
    with torch.inference_mode():
        hidden, _ = lm(dict(tokens=toks))
        fwd = lm_layers.unembed_logits(lm_model._unembed_table(params, cfg), hidden, cfg)
        cache = lm_decode.init_cache(cfg, LM_CHECK_BATCH, LM_CHECK_STEPS, DEVICE)
        errs = []
        for i in range(LM_CHECK_STEPS):
            logits, cache = lm.decode_step(cache, toks[:, i:i + 1], i)
            errs.append(float((logits - fwd[:, i]).abs().max()))
    scale = max(1.0, float(fwd.abs().max()))
    out = dict(arch=arch, params=sum(p.numel() for p in lm.parameters()),
               param_bytes=sum(p.numel() * p.element_size() for p in lm.parameters()),
               batch=LM_CHECK_BATCH, steps=LM_CHECK_STEPS, max_abs_err=max(errs),
               max_abs_logit=float(fwd.abs().max()), bound=LM_BOUND * scale,
               finite=bool(torch.isfinite(fwd).all()), wall_s=time.perf_counter() - t0)
    check(out["finite"] and out["max_abs_err"] <= out["bound"],
          f"{arch}: decode matches the teacher-forced forward at full width")
    return out, dict(cfg=cfg, params=params, toks=toks)


def _lm_card_vs_cpu(model: dict) -> dict:
    """(d): LM_CPU_STEPS decode steps of (c)'s full-width qwen on the card
    and, with the same parameters moved to the CPU, on the CPU."""
    cfg, toks = model["cfg"], model["toks"]
    cpu_params = map_tree(model["params"], lambda a: a.cpu())
    t0 = time.perf_counter()
    got, want = [], []
    with torch.inference_mode():
        for params, dev, out in ((model["params"], DEVICE, got), (cpu_params, "cpu", want)):
            cache = lm_decode.init_cache(cfg, LM_CHECK_BATCH, LM_CPU_STEPS, dev)
            for i in range(LM_CPU_STEPS):
                logits, cache = lm_decode.decode_step(
                    params, cache, {"tokens": toks[:, i:i + 1].to(dev), "pos": i}, cfg)
                out.append(logits.cpu())
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(1.0, max(float(b.abs().max()) for b in want))
    out = dict(arch=cfg.name, batch=LM_CHECK_BATCH, steps=LM_CPU_STEPS, max_abs_err=err,
               bound=LM_BOUND * scale, wall_s=time.perf_counter() - t0)
    check(err <= out["bound"], "full-width decode: the card agrees with the CPU")
    return out


def _lm_runner_vs_cpu(runner: ModelRunner) -> dict:
    """(e): the timed run's own state, bf16 at full width: from position
    LM_LATE_POS, LM_CPU_STEPS of the runner's ticks on the card (all its
    lanes, against its 256-token cache) and, from CPU copies of the same
    compute-dtype weights and cache, ``decode_step`` on the CPU fed the same
    tokens.  The logits and the cache rows written are held to the bf16
    bound."""
    cfg = runner.cfg
    t0 = time.perf_counter()
    cpu_weights = map_tree(runner.weights, lambda a: a.cpu())
    cpu_cache = {k: v.cpu() for k, v in runner.cache.items()}
    runner.pos = LM_LATE_POS
    logit_err, logit_bound = [], []
    with torch.inference_mode():
        for i in range(LM_CPU_STEPS):
            toks = runner.tokens.cpu()
            runner.tick()
            want, cpu_cache = lm_decode.decode_step(
                cpu_weights, cpu_cache, {"tokens": toks, "pos": LM_LATE_POS + i}, cfg)
            logit_err.append(float((runner.logits.cpu() - want).abs().max()))
            logit_bound.append(LM_BF16_BOUND * max(1.0, float(want.abs().max())))
    rows = slice(LM_LATE_POS, LM_LATE_POS + LM_CPU_STEPS)
    cache_err, cache_bound = [], []
    for k in ("k", "v"):
        want = cpu_cache[k][:, :, rows].float()
        cache_err.append(float((runner.cache[k][:, :, rows].cpu().float() - want).abs().max()))
        cache_bound.append(LM_BF16_BOUND * max(1.0, float(want.abs().max())))
    out = dict(arch=cfg.name, compute_dtype=str(cfg.compute_dtype), lanes=runner.slots,
               cache_len=runner.cache["k"].shape[2], positions=[LM_LATE_POS, runner.pos],
               logit_max_abs_err=logit_err, logit_bound=logit_bound,
               cache_rows_max_abs_err=cache_err, cache_rows_bound=cache_bound,
               wall_s=time.perf_counter() - t0)
    check(all(e <= b for e, b in zip(logit_err + cache_err, logit_bound + cache_bound)),
          "the runner's bf16 state at full width: the card agrees with the CPU")
    return out


def _tick_flops(runner: ModelRunner) -> dict:
    """For phase dryrun (c): the products of one of the runner's own decode
    ticks on the card, counted by ``FlopCounterMode`` (a tick attends over
    the whole cache whatever its position)."""
    from torch.utils.flop_counter import FlopCounterMode

    runner.pos = 0
    with FlopCounterMode(display=False) as fc:
        runner.tick()
    torch.cuda.synchronize()
    return dict(flops=fc.get_total_flops(), lanes=runner.slots, cache_len=runner.max_len,
                by_op={str(k): v for k, v in fc.get_flop_counts()["Global"].items()})


def _lm_serve_run(phase: str, runner: ModelRunner, requests: int, build_s: float) -> dict:
    """(a) of phases lm_serve and lm_families: the launcher's loop with the
    runner (the match kernels' counts set to 0 just before it and read just
    after), the same engine on the plain match beside it, and the checks."""
    cfg = runner.cfg
    held = torch.cuda.memory_allocated()
    match.match_tasks.launches = 0
    match.match_ranks.launches = 0
    match.match_ranks_batched.launches = 0
    run = _lm_serve_loop(runner, requests)
    launches = dict(match_tasks=match.match_tasks.launches,
                    match_ranks=match.match_ranks.launches,
                    match_ranks_batched=match.match_ranks_batched.launches)
    eng, s = run["eng"], run["stats"].summary()
    plain = _lm_plain_engine(requests)
    plain_equal = _engine_states_equal(_engine_state(eng), _engine_state(plain))
    check(match.match_tasks.launches == launches["match_tasks"],
          f"{phase}: the plain engine launches no kernel")
    ticks = len(run["step_ms"])
    steady = run["step_ms"][LM_STEADY_FROM:]
    steady_ms = float(np.mean(steady))
    occupancy = run["occupied_lane_steps"] / (ticks * runner.slots)
    serve = dict(
        arch=cfg.name, cfg=dict(layers=cfg.num_layers, d_model=cfg.d_model,
                                heads=cfg.num_heads, d_ff=cfg.d_ff,
                                padded_vocab=cfg.padded_vocab,
                                compute_dtype=str(cfg.compute_dtype)),
        **LM_SERVE, requests=requests, arrival_per_tick=LM_ARRIVAL, mean_gen=LM_MEAN_GEN,
        max_len=runner.max_len, completed=s["completed"], summary=s,
        engine_ticks=eng.stats.ticks,
        decode_ticks=ticks, lanes=runner.slots, lane_steps=ticks * runner.slots,
        occupied_lane_steps=run["occupied_lane_steps"], lane_occupancy=occupancy,
        decode_ms_per_step=steady_ms, decode_ms_per_step_median=float(np.median(steady)),
        decode_ms_per_step_p90=float(np.percentile(steady, 90)),
        steady_steps=[LM_STEADY_FROM, ticks],
        lane_steps_per_s=runner.slots * 1e3 / steady_ms,
        served_tokens_per_s=occupancy * runner.slots * 1e3 / steady_ms,
        plain_engine_identical=plain_equal,
        wall_s=run["wall"], engine_tick_s=run["engine_s"], decode_tick_s=run["decode_s"],
        host_syncs=run["syncs"], host_syncs_per_decode_tick=run["syncs"] / max(ticks, 1),
        kernel_launches=launches, gm_rounds=eng.gm_rounds, all_logits_finite=run["finite"],
        runner_build_s=build_s, memory_allocated_after_build=held,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    check(s["completed"] == requests == s["placed"], f"{phase}: every request completed")
    check(ticks == runner.max_len == runner.pos, f"{phase}: one decode tick per engine tick, "
          "to max_len")
    check(run["finite"], f"{phase}: every logit of every decode tick is finite")
    check(run["syncs"] == 0, f"{phase}: a decode tick makes no host sync")
    check(launches["match_tasks"] == eng.gm_rounds > 0,
          f"{phase}: gm_round calls == single-row kernel launches")
    check(plain_equal, f"{phase}: kernel and plain engines: identical stats and final state")
    return serve


def phase_lm_serve() -> dict:
    """Real-decode serving at qwen15_05b's full width: (a) the launcher's
    loop, with the same engine on the plain match beside it, (b) one decode
    step profiled, (e) the runner's own state on the card against the CPU,
    (c) decode against the teacher-forced forward (qwen and llama3_8b,
    fp32), (d) the card against the CPU."""
    t_phase = time.perf_counter()
    _reset_peak_memory()
    t0 = time.perf_counter()
    runner = ModelRunner(LM_ARCH, LM_SERVE["slots_per_pod"], max_len=LM_MAX_LEN, seed=0,
                         cfg=lm_config(LM_ARCH), device=DEVICE)
    torch.cuda.synchronize()
    serve = _lm_serve_run("lm_serve", runner, LM_REQUESTS, time.perf_counter() - t0)
    prof = _lm_profile(runner, LM_PROFILE_POS)
    check(prof["device_ops_per_step"] > 0, "the profiler saw the decode steps' device work")
    late = _lm_runner_vs_cpu(runner)
    tick_flops = _tick_flops(runner)
    del runner
    torch.cuda.empty_cache()
    checks, cpu = [], None
    for arch in LM_CHECK_ARCHS:
        r, model = _lm_decode_vs_forward(arch)
        checks.append(r)
        if arch == LM_ARCH:
            cpu = _lm_card_vs_cpu(model)
        del model
        torch.cuda.empty_cache()
    out = dict(phase="lm_serve", entry="launch.serve ModelRunner.tick (--real-decode)",
               serve=serve, profile=prof, runner_vs_cpu=late, decode_vs_forward=checks,
               card_vs_cpu=cpu, tick_flops=tick_flops,
               phase_wall_s=time.perf_counter() - t_phase)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase lm_families: the MoE, MLA, SSM and hybrid families at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _routes():
    """Every router call in the block, as (probabilities, top-k indices)
    on the host (a spy on ``moe.route``; the copies read the card back, so
    it stays out of timed or sync-counted runs)."""
    calls, route = [], lm_moe.route

    def spy(params, xg, cfg):
        out = route(params, xg, cfg)
        calls.append((out[0].cpu(), out[2].cpu()))
        return out

    lm_moe.route = spy
    try:
        yield calls
    finally:
        lm_moe.route = route


def _flips(ref_probs, ref_idx, got_idx, k: int, gap: float) -> tuple[torch.Tensor, bool]:
    """The tokens [N] whose top-k sets differ, and whether each such flip
    sits where the reference side's k-th / (k+1)-th gap is below ``gap``."""
    diff = (ref_idx.sort(-1).values != got_idx.sort(-1).values).any(-1)
    top = ref_probs.sort(-1, descending=True).values
    return diff, bool((top[..., k - 1] - top[..., k])[diff].lt(gap).all())


def _lmf_config(arch: str, layers, dtype):
    cfg = lm_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.moe:
        cf = max(LMF_CAPACITY, cfg.moe.num_experts / cfg.moe.top_k)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return dataclasses.replace(cfg, compute_dtype=dtype)


def _lmf_decode_vs_forward(arch: str, layers, steps: int, dtype, bound: float) -> dict:
    """(c): one full-width model alone on the card, weights drawn from a
    seeded generator on the card: each decode step's logits against the
    teacher-forced forward's at that position.  An MoE model's routing is
    recorded on both paths; a lane is compared until its routing first
    differs from the forward's, and a difference must sit at a gap below
    LMF_FLIP_GAP."""
    cfg = _lmf_config(arch, layers, dtype)
    t0 = time.perf_counter()
    lm = lm_model.LanguageModel(cfg, generator=torch.Generator(device=DEVICE).manual_seed(1),
                                device=DEVICE)
    build_s = time.perf_counter() - t0
    b = LM_CHECK_BATCH
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (b, steps), generator=gen,
                         dtype=torch.int32).to(DEVICE)
    with torch.inference_mode(), _routes() as calls:
        hidden, _ = lm(dict(tokens=toks))
        fwd = lm_layers.unembed_logits(lm_model._unembed_table(lm.tree(), cfg), hidden, cfg)
        n_fwd = len(calls)
        cache = lm_decode.init_cache(cfg, b, steps, DEVICE)
        errs = []
        for i in range(steps):
            logits, cache = lm.decode_step(cache, toks[:, i:i + 1], i)
            errs.append((logits - fwd[:, i]).abs().amax(-1))
        errs = torch.stack(errs).cpu()                        # [steps, B]
    clean, flips = torch.ones((steps, b), dtype=torch.bool), 0
    for layer in range(n_fwd):  # one forward call per MoE layer, then steps x layers
        probs, idx = (a.reshape(b, steps, -1) for a in calls[layer])
        for i in range(steps):
            diff, ok = _flips(probs[:, i], idx[:, i], calls[n_fwd + i * n_fwd + layer][1]
                              .reshape(b, -1), cfg.moe.top_k, LMF_FLIP_GAP[dtype])
            check(ok, f"{arch}: a routing flip at a gap >= {LMF_FLIP_GAP[dtype]}")
            clean[i:, diff] = False
            flips += int(diff.sum())
    scale = max(1.0, float(fwd.abs().max()))
    out = dict(arch=arch, layers=cfg.num_layers, compute_dtype=str(dtype),
               params=sum(p.numel() for p in lm.parameters()),
               param_bytes=sum(p.numel() * p.element_size() for p in lm.parameters()),
               capacity_factor=cfg.moe.capacity_factor if cfg.moe else None,
               batch=b, steps=steps, max_abs_err=float(errs[clean].max()),
               max_abs_err_all_lanes=float(errs.max()), compared_lane_steps=int(clean.sum()),
               routing_flips=flips, max_abs_logit=float(fwd.abs().max()),
               bound=bound * scale, finite=bool(torch.isfinite(fwd).all()),
               build_s=build_s, peak_memory=torch.cuda.max_memory_allocated(),
               wall_s=time.perf_counter() - t0)
    check(out["finite"] and out["max_abs_err"] <= out["bound"]
          and 2 * out["compared_lane_steps"] >= steps * b,
          f"{arch}: decode matches the teacher-forced forward at full width")
    return out


def _lmf_card_vs_cpu(arch: str, layers) -> dict:
    """(d): LM_CPU_STEPS fp32 decode steps of a full-width model on the
    card and, with the same parameters moved to the CPU, on the CPU, the
    routing recorded on both sides (the CPU is the reference side): the
    logits held on every lane whose routing agrees."""
    cfg = _lmf_config(arch, layers, torch.float32)
    t0 = time.perf_counter()
    card = lm_model.LanguageModel(cfg, generator=torch.Generator(device=DEVICE).manual_seed(3),
                                  device=DEVICE).tree()
    cpu_params = map_tree(card, lambda a: a.cpu())
    b, steps = LM_CHECK_BATCH, LM_CPU_STEPS
    toks = torch.randint(0, cfg.vocab_size, (b, steps), generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    logits, routes = {}, {}
    with torch.inference_mode():
        for side, params, dev in (("card", card, DEVICE), ("cpu", cpu_params, "cpu")):
            cache = lm_decode.init_cache(cfg, b, steps, dev)
            with _routes() as calls:
                out = []
                for i in range(steps):
                    lg, cache = lm_decode.decode_step(
                        params, cache, {"tokens": toks[:, i:i + 1].to(dev), "pos": i}, cfg)
                    out.append(lg.cpu())
            logits[side], routes[side] = torch.stack(out), calls
    clean, flips = torch.ones((steps, b), dtype=torch.bool), 0
    per_step = len(routes["cpu"]) // steps
    check(len(routes["card"]) == len(routes["cpu"]), f"{arch}: the same router calls")
    for c, ((probs, idx), (_, got)) in enumerate(zip(routes["cpu"], routes["card"])):
        diff, ok = _flips(probs.reshape(b, -1), idx.reshape(b, -1), got.reshape(b, -1),
                          cfg.moe.top_k, LMF_FLIP_GAP[torch.float32])
        check(ok, f"{arch}: card against CPU, a routing flip at a gap >= 1e-6")
        clean[c // per_step:, diff] = False
        flips += int(diff.sum())
    err = (logits["card"] - logits["cpu"]).abs().amax(-1)      # [steps, B]
    scale = max(1.0, float(logits["cpu"].abs().max()))
    out = dict(arch=arch, layers=cfg.num_layers, batch=b, steps=steps,
               max_abs_err=float(err[clean].max()) if clean.any() else None,
               compared_lane_steps=int(clean.sum()), routing_flips=flips,
               topk_card=[r[1].sort(-1).values.reshape(b, -1).tolist() for r in routes["card"]],
               topk_cpu=[r[1].sort(-1).values.reshape(b, -1).tolist() for r in routes["cpu"]],
               bound=LM_BOUND * scale, wall_s=time.perf_counter() - t0)
    check(clean.any() and out["max_abs_err"] <= out["bound"],
          f"{arch}: full-width decode, the card agrees with the CPU")
    return out


def phase_lm_families() -> dict:
    """The MoE, MLA, SSM and hybrid families: (a) DeepSeek-V2-Lite served at
    full width through the launcher's loop, with the same engine on the
    plain match beside it, (b) one decode step profiled with its bound,
    (c) decode against the teacher-forced forward, each model alone on the
    card (deepseek, mamba2 and zamba2 whole in fp32, arctic's first layer
    in bf16), (d) the card against the CPU (mamba2, deepseek's first two
    layers), (e) the phase's wall against its budget."""
    t_phase = time.perf_counter()
    _reset_peak_memory()
    t0 = time.perf_counter()
    runner = ModelRunner(LMF_ARCH, LM_SERVE["slots_per_pod"], max_len=LMF_MAX_LEN, seed=0,
                         cfg=lm_config(LMF_ARCH), device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    serve = _lm_serve_run("lm_families", runner, LMF_REQUESTS, build_s)
    serve.update(build_peak_memory=build_peak,
                 latent_cache_bytes=sum(x.numel() * x.element_size()
                                        for x in runner.cache.values()))
    parts = dict(a=time.perf_counter() - t_phase)
    prof = _lm_profile(runner, LMF_PROFILE_POS, LMF_PROFILE_STEPS)
    check(prof["device_ops_per_step"] > 0, "lm_families: the profiler saw the decode steps")
    tick_flops = _tick_flops(runner)
    del runner
    torch.cuda.empty_cache()
    parts["b"] = time.perf_counter() - t_phase - sum(parts.values())
    checks = []
    for arch, layers, steps, dtype, bound in LMF_CHECKS:
        _reset_peak_memory()
        checks.append(_lmf_decode_vs_forward(arch, layers, steps, dtype, bound))
        torch.cuda.empty_cache()
    parts["c"] = time.perf_counter() - t_phase - sum(parts.values())
    cpu = []
    for arch, layers in LMF_CPU:
        cpu.append(_lmf_card_vs_cpu(arch, layers))
        torch.cuda.empty_cache()
    parts["d"] = time.perf_counter() - t_phase - sum(parts.values())
    wall = time.perf_counter() - t_phase
    out = dict(phase="lm_families", entry="launch.serve ModelRunner.tick (--real-decode)",
               serve=serve, profile=prof, decode_vs_forward=checks, card_vs_cpu=cpu,
               tick_flops=tick_flops,
               reduced=dict(requests=[LMF_REQUESTS, LM_REQUESTS],
                            decode_ticks=[LMF_MAX_LEN, LM_MAX_LEN],
                            arctic_layers=[1, lm_config("arctic_480b").num_layers],
                            deepseek_layers_card_vs_cpu=[2, lm_config(LMF_ARCH).num_layers]),
               phase_wall_s=wall, part_walls_s=parts, budget_s=LMF_BUDGET_S,
               within_budget=wall <= LMF_BUDGET_S)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase train: training at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _step_spy(profile_at: int | None = None):
    """Every train step ``train_loop`` runs in the block, bracketed by CUDA
    events and its host syncs counted (a spy on ``loop.make_train_step``),
    with the metrics it returns (device tensors); step ``profile_at``
    (0-based) also under torch.profiler, tracing the card alone (a step is
    ~35,000 kernels, and the host's torch ops would triple what the
    profiler reads back).  Each checkpoint the loop saves is timed once the
    card has finished the step (a spy on ``checkpoint.save``).  Yields the
    steps' records and the saves' seconds."""
    from torch.profiler import ProfilerActivity, profile

    record, saves = [], []
    make, save = train_loop_mod.make_train_step, train_ckpt.save

    def spy(cfg, opt, accum_steps=1):
        step = make(cfg, opt, accum_steps)

        def timed(state, batch):
            profiled = len(record) == profile_at
            if profiled:
                torch.cuda.synchronize()
            ctx = profile(activities=[ProfilerActivity.CUDA]) if profiled else contextlib.nullcontext()
            with ctx as prof:
                t0 = time.perf_counter()
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                with sentinels.count_syncs() as c:
                    state, metrics = step(state, batch)
                ev[1].record()
                if profiled:
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
            record.append(dict(events=ev, syncs=c.count, sites=dict(c.sites), metrics=metrics))
            if profiled:
                record[-1]["profile"] = (prof, wall_ms)
            return state, metrics

        return timed

    def timed_save(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(*args, **kwargs)
        saves.append(time.perf_counter() - t0)
        return out

    train_loop_mod.make_train_step, train_ckpt.save = spy, timed_save
    try:
        yield record, saves
    finally:
        train_loop_mod.make_train_step, train_ckpt.save = make, save


def _train_profile(prof, prof_ms: float, step_ms: float) -> dict:
    """The profiled step's device busy and idle share against the timed
    steps' mean, its device ops, the top kernels."""
    busy_us, spans, by_name = _device_busy(prof)
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(step=TRAIN_PROFILE_STEP + 1, profiled_wall_ms=prof_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / step_ms,
                device_idle_share_profiled=1.0 - busy_ms / prof_ms,
                device_ops=len(spans), top_device_ms=[[k[:120], v] for k, v in top])


@contextlib.contextmanager
def _restore_spy(held: dict):
    """``train_loop``'s restore of LATEST made through ``restore(like=)``
    of ``held["state"]`` (the state in memory when the checkpoint was
    saved) and compared with it bitwise, which is then let go.  Yields what
    it saw."""
    seen, restore_latest = {}, train_ckpt.restore_latest

    def spy(ckpt_dir, like=None, *, device=None):
        t0 = time.perf_counter()
        state, step = restore_latest(ckpt_dir, like=held["state"], device=device)
        torch.cuda.synchronize()
        seen.update(step=step, restore_like_s=time.perf_counter() - t0)
        got, want = list(tree_items(state)), list(tree_items(held.pop("state")))
        seen["restore_like_bitwise"] = [p for p, _ in got] == [p for p, _ in want] and all(
            a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
        return state, step

    train_ckpt.restore_latest = spy
    try:
        yield seen
    finally:
        train_ckpt.restore_latest = restore_latest


def _train_card_vs_cpu(cfg, b: int, s: int) -> dict:
    """(c): one train step (no accumulation, TRAIN_CHECK_OPT) on the card
    and on the CPU from the same parameters (drawn on the CPU, seed 5) and
    pipeline batch (seed 1); the router's choices recorded on both sides."""
    t0 = time.perf_counter()
    params = init_params(lm_model.model_schema(cfg), torch.Generator().manual_seed(5), "cpu")
    batch = next(train_batches(cfg, b, s, seed=1, device="cpu"))
    sides = {}
    for side, dev in (("cpu", "cpu"), ("card", DEVICE)):
        p = map_tree(params, lambda a, dev=dev: a.to(dev, copy=True))
        state = {"params": p, "opt": init_opt_state(p, TRAIN_CHECK_OPT)}
        with _routes() as calls:
            state, m = train_loop_mod.make_train_step(cfg, TRAIN_CHECK_OPT)(
                state, {k: v.to(dev) for k, v in batch.items()})
        sides[side] = (state, {k: float(v) for k, v in m.items()}, calls)
    (cpu, mc, rc), (card, mg, rg) = sides["cpu"], sides["card"]
    routing_agrees = len(rc) == len(rg) and all(
        torch.equal(a[1].sort(-1).values, g[1].sort(-1).values) for a, g in zip(rc, rg))
    bound, rel = TRAIN_BOUND[cfg.compute_dtype], TRAIN_MOMENT_REL[cfg.compute_dtype]
    if cfg.param_dtype == torch.bfloat16:
        rel = max(rel, TRAIN_BF16_GRAD_REL)
    err = dict(loss=abs(mg["loss"] - mc["loss"]), grad_norm=abs(mg["grad_norm"] - mc["grad_norm"]))
    bad = [k for k in err if err[k] > bound * max(1.0, abs(mc[k]))]
    if mg["step"] != 1:
        bad.append("step")
    moment_err, step_err, stepped = {"m": 0.0, "v": 0.0}, 0.0, 0
    lr = TRAIN_CHECK_OPT.lr  # warmed up at step 1
    if routing_agrees:
        leaves = {side: {k: dict(tree_items(t)) for k, t in (
            ("p", st["params"]), ("m", st["opt"]["m"]), ("v", st["opt"]["v"]))}
            for side, st in (("cpu", cpu), ("card", card))}
        for path, p0 in tree_items(params):
            want = {k: t[path].float() for k, t in leaves["cpu"].items()}
            got = {k: t[path].cpu().float() for k, t in leaves["card"].items()}
            for k in ("m", "v"):
                e = float((got[k] - want[k]).abs().max())
                scale = float(want[k].abs().max())
                moment_err[k] = max(moment_err[k], e / scale if scale else e)
                if e > rel * scale:
                    bad.append((k, *path, e, scale))
            m = want["m"].abs()
            sel = m > max(rel * float(m.max()), TRAIN_STEP_MIN_M)
            if not bool(sel.any()):
                continue
            e = (got["p"][sel] - want["p"][sel]).abs() / lr
            slack = TRAIN_STEP_REL + torch.finfo(p0.dtype).eps * torch.maximum(
                p0.float()[sel].abs(), want["p"][sel].abs()) / lr
            stepped += int(sel.sum())
            step_err = max(step_err, float(e.max()))
            if bool((e > slack).any()):
                bad.append(("step", *path, float(e.max())))
        if not stepped:
            bad.append("no step above the moments' bound")
    out = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               compute_dtype=str(cfg.compute_dtype), batch=[b, s], loss=mc["loss"],
               loss_err=err["loss"], grad_norm=mc["grad_norm"], grad_norm_err=err["grad_norm"],
               moment_max_rel_err=moment_err["m"], v_max_rel_err=moment_err["v"],
               step_max_err=step_err, stepped_entries=stepped,
               routing_agrees=routing_agrees, bound=bound, moment_rel_bound=rel,
               step_bound=TRAIN_STEP_REL, check_lr=lr,
               wall_s=time.perf_counter() - t0)
    check(not bad, f"train step {cfg.name} ({cfg.compute_dtype}): the card agrees with the "
          f"CPU (outside the bounds: {bad[:6]}, {err})")
    return out


def phase_train() -> dict:
    """Training at qwen15_05b's full width: (a) 6 steps through
    ``train_loop``, step 2 profiled, (b) a restart from step 6's checkpoint,
    restored bitwise the state in memory, to step 7, (c) the card against
    the CPU, (d) the phase's wall against its budget."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    _reset_peak_memory()
    cfg = lm_config(TRAIN_ARCH)
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=build.BUILD_DIR)
    parts = {}
    try:
        data = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEVICE)
        with _step_spy(TRAIN_PROFILE_STEP) as (rec, saves):
            state, hist = train_loop_mod.train_loop(
                cfg, opt, data, steps=TRAIN_STEPS, checkpoint_dir=ckpt,
                checkpoint_every=TRAIN_CKPT_EVERY, log_every=TRAIN_CKPT_EVERY,
                accum_steps=TRAIN_ACCUM, device=DEVICE)
        torch.cuda.synchronize()
        parts["a"] = time.perf_counter() - t_phase
        losses = torch.stack([r["metrics"]["loss"] for r in rec]).tolist()
        gnorms = torch.stack([r["metrics"]["grad_norm"] for r in rec]).tolist()
        step_ms = [a.elapsed_time(b) for a, b in (r["events"] for r in rec)]
        timed = step_ms[TRAIN_TIMED_FROM:]
        ms = float(np.mean(timed))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        total, active = lm_model.param_counts(cfg)
        model_flops = 6.0 * active * tokens
        bound_ms = model_flops / BF16_OPS_PER_S * 1e3
        # the step's fp32 products (TF32 off), each run four times (forward,
        # recompute, two backward products): the unembedding and the
        # attention scores (all S x S of them, as computed), at the fp32 peak
        unembed_ops = 4 * 2 * tokens * cfg.d_model * cfg.padded_vocab
        scores_ops = (4 * 2 * TRAIN_BATCH * TRAIN_SEQ ** 2 * cfg.num_heads * cfg.head_dim_eff
                      * cfg.num_layers)
        fp32 = dict(unembedding_flops=unembed_ops, scores_flops=scores_ops,
                    unembedding_ms_at_fp32_peak=unembed_ops / SCALAR_OPS_PER_S * 1e3,
                    scores_ms_at_fp32_peak=scores_ops / SCALAR_OPS_PER_S * 1e3)
        log_steps = {int(h["step"]) for h in hist}
        syncs = [r["syncs"] for r in rec]
        run = dict(
            arch=cfg.name, cfg=dict(layers=cfg.num_layers, d_model=cfg.d_model,
                                    heads=cfg.num_heads, d_ff=cfg.d_ff,
                                    padded_vocab=cfg.padded_vocab,
                                    tie_embeddings=cfg.tie_embeddings,
                                    param_dtype=str(cfg.param_dtype),
                                    compute_dtype=str(cfg.compute_dtype), remat=cfg.remat,
                                    remat_policy=cfg.remat_policy, loss_chunk=cfg.loss_chunk),
            params=total, active_params=active, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
            accum_steps=TRAIN_ACCUM, tokens_per_step=tokens, steps=len(rec), lr=TRAIN_LR,
            warmup_steps=TRAIN_WARMUP, losses=losses, grad_norms=gnorms,
            history=hist, step_ms=step_ms, timed_steps=[TRAIN_TIMED_FROM + 1, len(rec)],
            ms_per_step=ms, ms_per_step_min=min(timed), ms_per_step_max=max(timed),
            tokens_per_s=tokens * 1e3 / ms, model_flops_per_step=model_flops,
            model_flops_formula="6 N D (roofline/analysis.py:178; N = active params)",
            ops_bound_ms=bound_ms, ops_bound_by="bf16 dense peak 989 TFLOP/s "
            "(NVIDIA H100 SXM data sheet)", model_flops_share=bound_ms / ms,
            fp32_products=fp32,
            host_syncs_per_step=syncs, sync_sites=[r["sites"] for r in rec if r["syncs"]],
            log_steps=sorted(log_steps), step_counter=int(state["opt"]["step"]),
            checkpoints=sorted(p.name for p in Path(ckpt).iterdir()),
            checkpoint_bytes=sum(
                f.stat().st_size for f in (Path(ckpt) / f"step_{TRAIN_STEPS}").iterdir()),
            save_s=saves, wall_s=parts["a"],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            reduced=dict(global_batch=[TRAIN_BATCH, 256]),
            profile=_train_profile(*rec[TRAIN_PROFILE_STEP]["profile"], ms))
        check(len(rec) == TRAIN_STEPS and all(map(math.isfinite, losses + gnorms)),
              "train: loss and grad norm finite at every step")
        check(losses[-1] < losses[0], "train: the loss at step 6 is below step 1's")
        check(run["step_counter"] == TRAIN_STEPS, "train: the step counter is 6")
        check(all(n == 0 for i, n in enumerate(syncs) if i + 1 not in log_steps),
              "train: no host sync in a step outside the log steps")
        check(run["profile"]["device_ops"] > 0, "train: the profiler saw the step's device work")
        # (b) the restart restores step 6 through restore(like=) of the state
        # in memory, compares the two bitwise and lets the old one go
        held = {"state": state}
        del state
        t0 = time.perf_counter()
        with _restore_spy(held) as restored, _step_spy() as (rec2, saves2):
            state2, hist2 = train_loop_mod.train_loop(
                cfg, opt, train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=DEVICE),
                steps=TRAIN_RESTART_STEPS, checkpoint_dir=ckpt,
                checkpoint_every=TRAIN_CKPT_EVERY, log_every=TRAIN_CKPT_EVERY,
                accum_steps=TRAIN_ACCUM, device=DEVICE)
        restart = dict(
            **restored, resumed_steps=len(rec2), step_counter=int(state2["opt"]["step"]),
            latest=train_ckpt.latest_step(ckpt), history=hist2,
            losses=torch.stack([r["metrics"]["loss"] for r in rec2]).tolist(),
            save_s=saves2, learn_margin=TRAIN_LEARN_MARGIN, wall_s=time.perf_counter() - t0)
        del state2
        torch.cuda.empty_cache()
        parts["b"] = time.perf_counter() - t_phase - sum(parts.values())
        check(restored.get("step") == TRAIN_STEPS and restored["restore_like_bitwise"],
              "train: restore(like=) of step 6 is bitwise the state after step 6")
        check(restart["resumed_steps"] == TRAIN_RESTART_STEPS - TRAIN_STEPS
              and restart["step_counter"] == restart["latest"] == TRAIN_RESTART_STEPS
              and all(map(math.isfinite, restart["losses"])),
              "train: the restart resumes from step 6 and ends at step 7")
        # the restarted loop's data starts over, as the reference's does: its
        # step sees step 1's batch again, after 6 updates
        check(restart["losses"][0] <= losses[0] - TRAIN_LEARN_MARGIN,
              f"train: after 6 steps the loss of step 1's batch is {TRAIN_LEARN_MARGIN} "
              "nats below step 1's")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    cpu = []
    for arch in list_archs():
        for dtype in (torch.float32, torch.bfloat16):
            cpu.append(_train_card_vs_cpu(
                dataclasses.replace(smoke_config(lm_config(arch)), compute_dtype=dtype),
                *TRAIN_SMOKE_SHAPE))
    cpu.append(_train_card_vs_cpu(dataclasses.replace(cfg, num_layers=TRAIN_CPU_LAYERS),
                                  *TRAIN_CPU_SHAPE))
    parts["c"] = time.perf_counter() - t_phase - sum(parts.values())
    check(all(c["routing_agrees"] for c in cpu if c["compute_dtype"] == str(torch.float32)),
          "train: in fp32 the card routes as the CPU does")
    wall = time.perf_counter() - t_phase
    out = dict(phase="train", entry="train.loop.train_loop (the loop launch/train.py runs)",
               run=run, restart=restart, card_vs_cpu=cpu,
               phase_wall_s=wall, part_walls_s=parts, budget_s=TRAIN_BUDGET_S,
               within_budget=wall <= TRAIN_BUDGET_S)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase dryrun: the distribution specs, the dry run and the H100 roofline
# ---------------------------------------------------------------------------


def _finite_terms(roof: dict) -> bool:
    return all(math.isfinite(roof[k]) and roof[k] >= 0
               for k in ("compute_s", "memory_s", "collective_s", "step_time_s"))


def _roof_line(res: dict) -> dict:
    """The roofline's terms of one ``run_cell`` result, in ms."""
    roof = res["roofline"]
    return dict(compute_ms=roof["compute_s"] * 1e3, memory_ms=roof["memory_s"] * 1e3,
                collective_ms=roof["collective_s"] * 1e3, step_ms=roof["step_time_s"] * 1e3,
                bottleneck=roof["bottleneck"], flops_per_chip=roof["hlo_gflops"] * 1e9,
                hbm_bytes_per_chip=roof["hlo_gbytes"] * 1e9,
                collective_bytes_per_chip=roof["collective_gbytes"] * 1e9,
                collective_counts=roof["collective_counts"],
                memory_per_device_bytes=roof["memory_per_device_gb"] * 1e9,
                state_resident_bytes=res["state_resident_gb"] * 1e9,
                activation_estimate_bytes=res["activation_resident_gb"] * 1e9)


def phase_dryrun(lm: dict, lmf: dict, trn: dict) -> dict:
    """The dry run and the roofline: (a) three production cells on the H100
    meshes, every term finite; (b) the roofline of the steps phases
    lm_serve, lm_families and train measured, on the one card, against
    those measurements; (c) the runners' ticks counted on the card against
    the meta trace and ``_lm_step_ops``."""
    t_phase = time.perf_counter()
    parts = {}
    production = []
    for arch, shape, mesh_name in DRYRUN_CELLS:
        t0 = time.perf_counter()
        res = lm_dryrun.run_cell(arch, shape, mesh_name, verbose=False)
        production.append(dict(arch=arch, shape=shape, mesh=mesh_name, chips=res["chips"],
                               fsdp=res["fsdp"], units=res["units"], **_roof_line(res),
                               collectives_by_axis=res["collectives_by_axis"],
                               link_gbps_by_axis=res["link_gbps_by_axis"],
                               wall_s=time.perf_counter() - t0))
        check(_finite_terms(res["roofline"]) and res["roofline"]["hlo_gflops"] > 0,
              f"dryrun {arch}/{shape}/{mesh_name}: every term finite and >= 0, FLOPs > 0")
    parts["a"] = time.perf_counter() - t_phase

    mesh = make_host_mesh()
    check(mesh_axis_sizes(mesh) == {"data": 1, "model": 1},
          "make_host_mesh() is (1, 1) on the one card")
    lanes = LM_SERVE["slots_per_pod"]
    # the runners hold compute-dtype weights: their cells carry it as the
    # parameter dtype; the train state is the config's (fp32 parameters
    # and moments, bf16 compute)
    serve_cfg = dataclasses.replace(lm_config(LM_ARCH), param_dtype=torch.bfloat16)
    lmf_cfg = dataclasses.replace(lm_config(LMF_ARCH), param_dtype=torch.bfloat16)
    run = trn["run"]
    steps = (
        ("lm_serve", serve_cfg, ShapeCell("lm_serve", "decode", LM_MAX_LEN, lanes),
         lm["serve"]["decode_ms_per_step"], lm["serve"]["max_memory_allocated"]),
        ("lm_families", lmf_cfg, ShapeCell("lm_families", "decode", LMF_MAX_LEN, lanes),
         lmf["serve"]["decode_ms_per_step"], lmf["serve"]["max_memory_allocated"]),
        ("train", lm_config(TRAIN_ARCH), ShapeCell("train", "train", TRAIN_SEQ, TRAIN_BATCH),
         run["ms_per_step"], run["max_memory_allocated"]),
    )
    calibration = []
    for name, cfg, cell, step_ms, peak in steps:
        t0 = time.perf_counter()
        res = lm_dryrun.run_cell(cfg.name, cell.name, "host", verbose=False, cfg=cfg,
                                 cell=cell, mesh=mesh)
        r = _roof_line(res)
        calibration.append(dict(
            phase=name, arch=cfg.name, kind=cell.kind, batch=cell.global_batch,
            seq_len=cell.seq_len, param_dtype=str(cfg.param_dtype),
            compute_dtype=str(cfg.compute_dtype), **r,
            measured_step_ms=step_ms, measured_over_roofline=step_ms / r["step_ms"],
            measured_peak_bytes=peak,
            state_over_peak=r["state_resident_bytes"] / peak,
            activation_estimate_over_peak=r["activation_estimate_bytes"] / peak,
            wall_s=time.perf_counter() - t0))
        check(_finite_terms(res["roofline"]), f"dryrun {name}: every term finite and >= 0")
        check(step_ms >= DRYRUN_STEP_SLACK * r["step_ms"],
              f"dryrun {name}: the measured step ({step_ms:.3f} ms) is no faster than "
              f"{DRYRUN_STEP_SLACK} x its roofline ({r['step_ms']:.3f} ms)")
        check(r["state_resident_bytes"] <= peak,
              f"dryrun {name}: the predicted resident state is within the measured peak")
    parts["b"] = time.perf_counter() - t_phase - sum(parts.values())

    counts = []
    for name, cfg, tick in (("lm_serve", serve_cfg, lm["tick_flops"]),
                            ("lm_families", lmf_cfg, lmf["tick_flops"])):
        cell = ShapeCell(name, "decode", tick["cache_len"], tick["lanes"])
        meta, _ = lm_dryrun.trace_cell(cfg, cell, mesh)
        bf16, fp32 = _lm_step_ops(cfg, tick["lanes"], lm_decode.cache_len(cfg, cell.seq_len))
        counts.append(dict(phase=name, arch=cfg.name, lanes=tick["lanes"],
                           cache_len=tick["cache_len"], card_flops=tick["flops"],
                           meta_flops=meta.get_total_flops(), card_by_op=tick["by_op"],
                           step_ops_bf16=bf16, step_ops_fp32=fp32,
                           step_ops_over_meta=(bf16 + fp32) / meta.get_total_flops()))
        check(tick["flops"] == meta.get_total_flops() > 0,
              f"dryrun {name}: FlopCounterMode on the card counts the meta trace's FLOPs")
        if cfg.name == LM_ARCH:
            check(bf16 + fp32 == meta.get_total_flops(),
                  f"dryrun {name}: _lm_step_ops counts every product the trace counts")
    parts["c"] = time.perf_counter() - t_phase - sum(parts.values())
    wall = time.perf_counter() - t_phase
    out = dict(phase="dryrun", entry="launch.dryrun.run_cell / trace_cell",
               production=production, calibration=calibration, flop_counts=counts,
               step_slack=DRYRUN_STEP_SLACK,
               constants=dict(peak_flops=roofline.PEAK_FLOPS, hbm_bw=roofline.HBM_BW,
                              nvlink_bw=roofline.NVLINK_BW, ib_bw=roofline.IB_BW),
               phase_wall_s=wall, part_walls_s=parts, budget_s=DRYRUN_BUDGET_S,
               within_budget=wall <= DRYRUN_BUDGET_S)
    emit(out)
    return out


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    emit(dict(phase="env", python=sys.version.split()[0], torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0)))

    walls = {}

    def run(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    run("build", phase_build)
    kern = run("kernel", phase_kernel, gen)
    single = run("kernel_single", phase_kernel_single, gen)
    wl = synthetic_trace(**TRACE)
    megha = run("megha", phase_megha, wl)
    plain = run("megha_plain", phase_megha_plain, wl, megha)
    sync = run("megha_sync", phase_megha_sync, wl)
    megha.update(
        rounds=plain["rounds"], borrow_rounds=plain["borrow_rounds"],
        launches_equal_rounds_plus_borrow=(
            megha["kernel_launches"] == plain["rounds"] + plain["borrow_rounds"]),
        host_syncs=sync["host_syncs"], host_syncs_per_round=sync["host_syncs_per_round"],
    )
    emit(megha)
    run("megha_profile", phase_megha_profile, wl)
    orc = run("oracle", phase_oracle, wl, megha)
    strm = run("stream", phase_stream, wl)
    tel = run("telemetry", phase_telemetry, wl)
    run("telemetry_profile", phase_telemetry_profile, wl)
    swp = run("sweep", phase_sweep, megha)
    sweep_plans, sweep_draws = swp.pop("_plans"), swp.pop("_draws")
    run("sweep_profile", phase_sweep_profile, sweep_plans)
    brk = run("breakdown", phase_breakdown, swp, sweep_plans, sweep_draws)
    ana = run("analysis", phase_analysis, sweep_plans, sweep_draws)
    del sweep_plans, sweep_draws
    fig4 = run("fig4", phase_fig4)
    fig4_plans = fig4.pop("_plans")
    run("fig4_profile", phase_fig4_profile, fig4_plans)
    fprov = run("fault_provenance", phase_fault_provenance, fig4, fig4_plans)
    del fig4_plans
    shd = run("shard", phase_shard, swp, fig4, strm)
    strm.pop("_runs")
    fig4.pop("_summaries")
    elong = run("eagle_long", phase_eagle_long)
    serve = run("serve", phase_serve)
    lm = run("lm_serve", phase_lm_serve)
    lmf = run("lm_families", phase_lm_families)
    trn = run("train", phase_train)
    run("dryrun", phase_dryrun, lm, lmf, trn)
    run("serve_profile", phase_serve_profile)
    sdps = run("sdps", phase_sdps)
    run("cpu_parity", phase_cpu_parity)

    borrow = next(r for r in kern["rows"] if r["caller"] == "megha_borrow")
    fleet = next(r for r in single["rows"] if r["caller"] == "serve_sdps")
    emit({"kernels": [dict(
        name="match_ranks_batched", route="cuda",
        source="src/repro_torch/kernels/csrc/match.cu",
        replaces="src/repro/kernels/match.py:31",
        launches=megha["kernel_launches"],
        launches_by_path=dict(
            megha=megha["kernel_launches"], oracle=orc["kernel_launches"],
            sweep=sum(r["kernel_launches"] for r in swp["rules"].values()),
            sweep_by_rule={k: r["kernel_launches"] for k, r in swp["rules"].items()},
            pigeon=swp["rules"]["pigeon"]["kernel_launches"],
            sparrow=swp["rules"]["sparrow"]["kernel_launches"],
            eagle=swp["rules"]["eagle"]["kernel_launches"],
            eagle_long=elong["kernel_launches"],
            fig4=sum(r["kernel_launches"] for r in fig4["rules"].values()),
            fig4_by_rule={k: r["kernel_launches"] for k, r in fig4["rules"].items()},
            telemetry_by_rule={k: r["kernel_launches"] for k, r in tel["rules"].items()},
            breakdown=sum(r["kernel_launches"] for r in brk["rules"].values()),
            breakdown_by_rule={k: r["kernel_launches"] for k, r in brk["rules"].items()},
            fault_provenance=fprov["kernel_launches"],
            analysis_fixed_by_rule={k: r["fixed_kernel_launches"]
                                    for k, r in ana["rules"].items()},
            stream_by_rule={k: r["kernel_launches"] for k, r in strm["rules"].items()},
            shard=dict(
                fig2_by_rule={k: r["kernel_launches"] for k, r in shd["fig2"].items()},
                fig4_megha=shd["fig4_megha"]["kernel_launches"],
                curve_by_rule={k: r["kernel_launches"] for k, r in shd["curve"].items()},
                curve_plain_megha=shd["plain_megha"]["match_launches"])),
        max_abs_err=max(kern["sweep_err"], *(r["max_abs_err"] for r in kern["rows"])),
        shape=borrow["shape"], ms=borrow["ms"], plain_ms=borrow["plain_ms"],
        bound_ms=borrow["bound_ms"], bound_by=borrow["bound_by"],
        library_ms=borrow["library_ms"],
        library_call="torch.cumsum (the scan alone)",
        designs=[dict(
            design=design,
            shapes=[{k: r[k] for k in ("caller", "shape", "n", "ms", "plain_ms",
                                       "library_ms", "bound_ms")}
                    for r in kern["rows"] if r["design"] == design],
            **({"tile_lanes": match.WIDE_TILE_LANES} if design == "wide"
               else {"max_lanes": match.NARROW_MAX_LANES}),
        ) for design in ("wide", "narrow")],
    ), dict(
        name="match_ranks", route="cuda",
        source="src/repro_torch/kernels/csrc/match_tasks.cu",
        replaces="src/repro/kernels/match.py:97",
        entry="match_tasks (match_ranks with the inverse scatter fused in)",
        launches=serve["kernel_launches"]["match_tasks"]
        + serve["kernel_launches"]["match_ranks"],
        launches_by_path=dict(serve=serve["kernel_launches"]["match_tasks"],
                              lm_serve=lm["serve"]["kernel_launches"]["match_tasks"],
                              lm_families=lmf["serve"]["kernel_launches"]["match_tasks"],
                              sdps=sdps["kernel_launches"],
                              quickstart=ana["quickstart"]["kernel"]["kernel_launches"]),
        max_abs_err=max(single["sweep_err"], *(r["max_abs_err"] for r in single["rows"])),
        shape=fleet["shape"], ms=fleet["ms"], plain_ms=fleet["plain_ms"],
        bound_ms=fleet["bound_ms"], bound_by=fleet["bound_by"],
        library_ms=fleet["library_ms"],
        library_call="torch.cumsum (the scan alone)",
        by_shape=[{k: r[k] for k in ("caller", "shape", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "ranks_ms", "ranks_bound_ms")}
                  for r in single["rows"]],
    ), dict(
        name="p2_sketch", route="cuda",
        source="src/repro_torch/kernels/csrc/p2_sketch.cu",
        replaces="src/repro/simx/telemetry.py:440 (sketch_absorb's lax.scan; not a TPU kernel)",
        launches=sum(r["p2_launches"] for r in strm["rules"].values()),
        launches_by_path=dict(
            stream_by_rule={k: r["p2_launches"] for k, r in strm["rules"].items()},
            shard=dict(curve_by_rule={k: r["p2_launches"] for k, r in shd["curve"].items()},
                       curve_plain_megha=shd["plain_megha"]["p2_launches"])),
        max_abs_err=0.0 if strm["p2"]["bitwise_every_absorb"] else None,
        shape=[strm["p2"]["timed_absorb"]["values"]], ms=strm["p2"]["ms"],
        plain_ms=strm["p2"]["plain_ms"], bound_ms=strm["p2"]["bound_ms"],
        bound_by=strm["p2"]["bound_by"],
        bound_parts_ms={k: strm["p2"][k] for k in ("bytes_ms", "ops_ms", "chain_ms")},
        library_ms=None,
        lanes={k: kern["p2_lanes"][k] for k in (
            "shape", "valid_per_lane", "ms", "one_lane_ms", "plain_ms", "bound_ms",
            "bound_by", "bytes_ms", "ops_ms", "chain_ms", "library_ms")},
    )]})
    print(nvidia_smi(), flush=True)
    emit(dict(phase="total", wall_s=time.perf_counter() - t_start, phase_walls_s=walls))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
