#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (distributions_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. build      -- compile the kernels K1 and B5 (csrc/fused_v2.cu), K2 and
                 K3 (csrc/fused_v3.cu), K4 and K5 (csrc/score_sample_v1.cu;
                 all three with the slot-split walk of csrc/fused_split.cuh,
                 K1 and K2 with the stat stage of csrc/fused_stats.cuh),
                 B2, B3 and B4 (csrc/roofline.cu) and B1
                 (csrc/sampler_bench.cu) with nvcc from the sources in this
                 checkout, the compilers started together; print the card's
                 name and power limit.
1a. kernel_b4, kernel_b2, kernel_b3 -- the roofline kernels against their
                 plain-PyTorch twins at the entry point's sizes: the
                 streamed copy B4 (TMA bulk-copy ring) exact over 512 MB
                 and at lengths around its chunk and ring, timed as 10
                 calls back to back beside torch.add; the dependent chain
                 B2 at every op and depth (exact for add, mul, fma,
                 fast_log, fast_exp and philox, rtol 1e-5 for logf, expf,
                 log1pf, rsqrtf) and at 4096 x 1024 elements, T = 256; the
                 tensor-core product B3 (one persistent wgmma launch a
                 call) at 1024^3, exact on integer operands from {-1, 0,
                 1} and {-4, ..., 4} at 1024 and 2048 and with every
                 buffer poisoned, within 5e-3 of the rms plus 1e-2 of the
                 element on normal ones (N = 256, 1024, 2048, and the
                 timed 512 steps; distances to the float64 function of
                 kernel and twin printed), beside 1024 torch.matmul
                 replayed from one CUDA graph; milliseconds of kernel,
                 twin and library call, and each new kernel's -Xptxas -v
                 line.
1b. roofline  -- benchmarks.roofline.measure(): the card's measured rates
                 (evaluations/s per op from B2's slope between depths 1 and
                 9, a Philox block among the ops, FLOP/s of B3, bytes/s of
                 B4).  They give every kernel
                 below a measured bound beside the nominal one.
1c. kernel_phases -- benchmarks.kernel_phases.run(): K1 cut into cumulative
                 phases (B5) over 1,048,576 rows x 1024 slots in tiles of
                 131072, at the entry point's one nich column and at the
                 flagship's two; the split of K1's time, and the cost of a
                 Philox block in place beside the generator alone.
1d. kernel_b5, kernel_b1 -- B5 at K1's flagship tile: 'noop' and
                 'score_max' equal to their twins, 'score_bits' within its
                 perturbation of the row maximum, 'score_<mode>' equal to
                 K1's draws and 'full_<mode>' to K1's outputs, bitwise.  B1
                 at 2048 rows x C = 256, 1024, 4096: 0 mismatches in
                 'argmax' and 'gumbel_host', a z-test in 'gumbel', bitwise
                 repeatability.
1e. suite     -- benchmarks.suite sections kernel_sampler (B1) and
                 hyper_grid at their default sizes.
2. kernel     -- K1 against its plain-PyTorch twin on the card at the
                 flagship tile (B=131072 rows x C=1024 slots x 2 nich
                 columns, state built from the flagship data): equal draws
                 in 'argmax', 'argmax_fast', 'gumbel_host' and 'cdf_host'
                 (near ties counted and bounded), stat sums within
                 tolerance, slot-frequency z-tests against the softmax of
                 mixture.score_batch for the in-kernel-RNG modes, bitwise
                 repeatability, a ragged C=1000 x B=3000 case (also in
                 two nich blocks of (2, 3) columns: the split walk's wide
                 shape), median kernel and twin milliseconds per mode (in
                 'gumbel' and 'cdf' also with the seed read from device
                 memory, the main path's launch, which must equal the
                 by-value launch bitwise in 'gumbel', 'gumbel_fast',
                 'cdf' and 'argmax'); 'gumbel' and 'gumbel_fast' equal to
                 'gumbel_host' on
                 fused_kernels.philox_gumbel_noise (the Philox counter
                 and word exactly; near-ties only may differ); the split
                 kernel's registers, local bytes, shared memory,
                 occupancy and waves, and -Xptxas -v over its
                 instantiations.
3. kernel_k2  -- the same for K2 at one tile of B=65536 x C=1024 in two
                 layouts, niw2mix (niw d=2 + nich + bb) and bbddgp
                 (bb + dd + gp, no nich block), with the count tables
                 exactly equal; the ragged case is niw d=3 + nich + bb
                 (the wide shape).  The Philox check and the split
                 kernel's report as well, also for the wide shape.
3a. kernel_stats -- K1's and K2's stat stage (csrc/fused_stats.cuh) alone,
                 through bench_kernels.stat_sums / mixed_stat_sums: against
                 the twins' one-hot sums (float sums within rtol 1e-5 /
                 atol 1e-3, count tables exact), two launches bitwise
                 equal and a CUDA graph replay bitwise equal to an eager
                 launch, with every row in one slot, uniform slots,
                 Pitman-Yor-skewed slots, slots outside [0, C), the
                 kernels' own 'gumbel' draws, ragged B (131,072 - 77 and
                 3001), at C = 1024 and 8192, K2 on niw2mix and on bbddgp
                 (count tables alone); then milliseconds a launch at
                 16,384, 65,536 and 131,072 rows (CUDA events over graph
                 replays, and the profiler's device time of its two
                 kernels) beside the twin and torch.Tensor.index_add_ of
                 the prebuilt features, and at 8192 slots against 1024.
3b. kernel_k3 -- the pair kernel K3 at B=65536 x C_local=256, the four
                 component shards of the K2 problems above (niw2mix and
                 bbddgp), and once at C_local=1024: equal to its twin in
                 'argmax', 'argmax_fast' and 'gumbel_host' (slot exactly,
                 best score within 1e-6); the four shards' pairs reduced
                 (largest best, then lowest slot) equal to K2's draw on the
                 whole slot axis in 'argmax', 'gumbel_host' and 'gumbel';
                 z-tests of the reduced draws in 'gumbel' and
                 'gumbel_fast'; bitwise repeatability; a ragged case with
                 odd slot offsets; milliseconds of kernel and twin; the
                 seed read from device memory (the 2-D sweep's CUDA graph)
                 bitwise the by-value launch in 'argmax', 'gumbel' and
                 'gumbel_fast', both timed in turns; the Philox check on
                 each shard at its slot offset, and the split kernel's
                 report.
3c. kernel_k4, kernel_k5 -- the v1 score + sample kernels (no stat
                 outputs; the slot-split walk in its v1 form) against their
                 twins: K4 at B=131072 x C=1024 x 2 nich, K5 at B=65536 x
                 C=1024 on nich + bb + dd + gp and on bb + dd + gp without
                 a nich column, each with ragged C=1000 x B=3000 cases (K4
                 on 2 and on 5 nich columns, K5 on nich + gp + bb, dd + bb
                 and random inputs of 3 nich and 5 table columns; 5
                 columns and 3 + 5 take the wide shape): equal draws in
                 'argmax' and 'gumbel_host', z-test in 'gumbel', bitwise
                 repeatability, milliseconds of kernel and twin; 'gumbel'
                 equal to 'gumbel_host' on fused_kernels.philox_gumbel_noise
                 at every one of those inputs, and the split kernel's
                 report and -Xptxas -v as for K1; the seed read from
                 device memory (the v1 sweeps' CUDA graph) bitwise the
                 by-value launch in 'gumbel' and 'argmax', both timed in
                 turns.
4. small_reference, small_reference_mixed -- the kernel path on the card
                 against the twin path on the CPU, draw for draw in a
                 3-sweep 'argmax' run of a small problem.
5. main       -- run_gibbs(use_pallas=True, sampling='gumbel') in the
                 flagship runner configuration (1,048,576 rows x 1024
                 slots x 2 nich, Pitman-Yor, tiles of 131072 rows, warm
                 start from the generating labels; 3 steps of 10 sweeps);
                 K1's launch count must equal tiles x sweeps, and in the
                 last step, run under torch.profiler, the kernels the
                 device ran must equal the launches the wrapper counted
                 (replays included) and tiles x sweeps; that step also
                 gives the device's busy share of a steady step.  Then one
                 run_sweeps_pallas_fused
                 call and one plain sweep_blocked sweep at the same size,
                 and a profile of one fused sweep.
6. main_mixed -- the same runner on niw2mix at 1,048,576 rows x 1024
                 slots, tiles of 65536 rows; K2's launch count must equal
                 tiles x sweeps, in the run and in its profiled last
                 step, as for main.  Then one plain sweep and the profile of
                 one fused sweep.
6b. paths_v1  -- gibbs.sweep_blocked_pallas (K4) on the flagship nich
                 data and gibbs.sweep_blocked_pallas_mixed (K5, and its
                 plain 'xla' backend) on nich + bb + dd + gp, both at
                 1,048,576 rows x 1024 slots, each sweep the replay of
                 one CUDA graph of all its tiles (K4 and K5 reading their
                 seed from the seed table, 'xla' drawing from the graph's
                 registered device generator): 10 chained sweeps in
                 'gumbel' and 'argmax' ('xla': 'gumbel') bitwise equal to
                 the eager loop (gibbs._eager_sweeps), one capture and 9
                 replays, launches = tiles x sweeps; two replays with
                 fresh seeds and other draws, each equal to the eager
                 sweep; the profile of one replayed sweep (one K4 / K5
                 launch a tile, required); ms per sweep on the graph and
                 eagerly in turns, capture seconds, pool bytes; counts
                 equal to a bincount of the assignments, score_data equal
                 to a fresh recompute; the fused and plain sweeps of the
                 same problem timed beside.
6a. graphs    -- each sweep of run_gibbs(use_pallas=True) as the replay of
                 one CUDA graph of all its tiles (gibbs._SweepGraph, K1 and
                 K2 reading their seed from device memory) against the
                 eager loop with the seeds passed by value
                 (gibbs._eager_sweeps), at 1,048,576 rows x 1024 slots on
                 nich2 (8 tiles) and niw2mix (16 tiles): 10 sweeps with
                 the step's score in 'gumbel', 'argmax' and 'cdf', bitwise
                 equal (assignments, counts, float stat sums, cache,
                 score), one capture and 9 replays each (after the key's
                 first call, which runs eagerly), launches = tiles x
                 sweeps; two consecutive replays with other seeds (the
                 seed table of random.sweep_seeds) and other draws, each
                 equal to the eager sweep; what a call returned unchanged
                 by the next call and not the graph's buffers; the
                 profile of one replayed sweep (the score + sample kernel
                 once a tile, required) beside one eager sweep; a call made
                 once (a fresh copy of the values) taking the eager loop
                 and capturing nothing, timed against the eager loop in
                 turns; a run that grows
                 its capacity mid-run (65,536 rows, capacity 32)
                 recapturing and equal to the eager run; main_hypers' run
                 and LowEntropy on both layouts (2 steps of 3 sweeps),
                 graph against eager, bitwise; ms per sweep of run_gibbs,
                 graph and eager in turns, with the device ms and busy
                 share of a sweep, capture seconds and pool bytes.  The
                 runner phases (main, main_mixed, main_le, main_hypers)
                 also check that every sweep but a graph's first came
                 from its replay (gibbs.GRAPH_STATS).
6f. plain_graphs -- the single-device plain sweeps as CUDA graphs, the
                 tiles drawing from the graph's registered device
                 generator, reseeded from the host before each replay:
                 sweep_blocked on nich2 (tiles of 4096 and 131,072 rows)
                 and niw2mix (65,536) at 1,048,576 rows x 1024 slots, 3
                 chained sweeps bitwise the eager loop, fresh seeds, ms
                 per sweep in turns; run_gibbs(use_pallas=False) on nich2
                 at its default 4096-row tiles (4096 slots: a tile opens
                 up to one cluster, 256 a sweep), 3 steps of 3 sweeps,
                 every sweep but the first a replay (and the step's score
                 from its graph), bitwise its eager run and its
                 interrupted and resumed run; sweep_blocked_chains, 4
                 chains of 65,536 rows in one replay a sweep, bitwise the
                 eager chains.
6c. main_resume -- run_gibbs with checkpoint_path in a temporary
                 directory: an uninterrupted run against an interrupted
                 and resumed one, bitwise, on the fused path at full width
                 and on the plain path at a smaller size; save and load
                 seconds and the file's size.
6d. init      -- run_gibbs with its default init='prior' at full width and
                 with init='sequential' on a few hundred rows; ms per row
                 of both.
6e. sharded   -- the sharded fused sweeps on in-process meshes on the one
                 card at 1,048,576 rows x 1024 slots, each sweep the
                 replay of one CUDA graph of all its tiles and local
                 shards: sharded_sweep_fused on 4 row shards (nich2 on K1,
                 niw2mix on K2) in 'argmax', 'cdf' and 'gumbel', and
                 sharded_sweep_2d_fused on a 2 x 4 mesh (niw2mix, K3 at
                 C_local=256, reading its seed from the table) in 'argmax'
                 and 'gumbel': 10 sweeps with the graph equal to 10 under
                 gibbs._eager_sweeps() bitwise, one capture and 9 replays,
                 launches = tiles x shards x sweeps; two replays with other
                 seeds and draws, each equal to the eager sweep; a replayed
                 sweep under the profiler with exactly tiles x shards
                 score + sample kernels; ms per sweep, graph and eager in
                 turns, capture seconds and pool bytes, beside the
                 single-device graph; counts equal a bincount, score_data
                 equals a fresh recompute, every component shard keeps an
                 alive empty slot.  At 262,144 rows the plain
                 sharded_sweep_2d, sharded_sweep_components and
                 sharded_sweep_blocked (eager by rule), and 'argmax' 2-D
                 fused against 'argmax' 2-D plain (equal but for
                 near-ties, at most one row in 10,000).  N shards on one
                 card measure the sharded code's overhead, not a speed-up.
6f. main_mesh -- run_gibbs(mesh=make_mesh(4)) on nich2 at full width with
                 a checkpoint, 3 steps of 3 sweeps: every sweep but the
                 first replayed from the step's CUDA graph, and in the
                 profiled last step the device's kernels equal to the
                 launches counted; an interrupted plus resumed run against
                 it, bitwise.
6g. process_group -- distributed.initialize with NCCL at world size 1, a
                 make_global_mesh() sweep of 3 sweeps replayed from its CUDA
                 graph (the NCCL all_reduce inside it) equal to its eager
                 loop and to the single-device sweep, bitwise;
                 destroy_process_group.  More than one rank is not run:
                 the machine has one card.
6h. main_hypers -- run_gibbs with hyperparameter moves on nich2 at full
                 width: a 64-point sigmasq grid and an 8 x 8 Pitman-Yor
                 grid every 5 of 10 sweeps; the chosen indices, the final
                 shareds equal to the logged grid points, score_data equal
                 to a fresh recompute under the hyperparameters in force,
                 ms per hyper step beside ms per sweep.
6i. main_le   -- run_gibbs(use_pallas=True) with the LowEntropy prior
                 {dataset_size=1,048,576} on nich2 (K1) and niw2mix (K2) at
                 1,048,576 rows x 1024 slots from the generating labels, 2
                 steps of 5 sweeps: launches = tiles x sweeps, the state
                 equal to state_from_assignments, score_data equal to a
                 recompute, tile 0 in 'argmax' against the plain path's
                 argmax (near-ties only); ms per sweep and the profile of
                 one fused sweep.
6i'. reference_configs -- the JAX package's documented benchmark
                 configurations (benchmarks/bench_runner.py, bench.py at
                 BENCH_COMPONENTS=8192 and BENCH_FEATURES=1) through
                 run_gibbs(use_pallas=True) at 1,048,576 rows, 50 sweeps a
                 step, 7C/8 generating clusters (3C/4 where 7C/8 fills
                 1024 slots: nich2, nich1), warm from their labels,
                 grow_headroom=0, 'gumbel': nich2 at 1024 slots (3 steps)
                 and at 8192 (2), one nich column (K1's one-column shape)
                 and the bb model under a CRP (K2 with one table column),
                 one line each: run_main's launch, graph and profile
                 checks, check_state, capacity unchanged, ms/sweep (median
                 of the steps after the first), cells/s, the device split
                 of a replayed sweep, occupied groups per step.  Then at
                 8192 slots: sweep_blocked_pallas (K4), sweep_blocked and
                 sharded_sweep_2d_fused on 2 x 4 (K3, slot offsets up to
                 6144) graph against eager, bitwise, timed in turns; K1,
                 K3 (each shard, the last timed), K4 and K2 on the bb
                 layout (also at 1024) against their twins in 'argmax' and
                 'gumbel_host', 'gumbel' on its Philox noise, ms and
                 shares of the bounds.
6j. moves     -- on the nich2 state at full width: one sweep_mh (tiles of
                 131,072, 4 steps), 20 split_merge_move and 3
                 split_merge_restricted (no depth cut), sweep_sequential at
                 4096 rows x 1024 slots and sweep_blocked_chains on 4 chains
                 of 65,536 rows; every state equal to state_from_assignments
                 of its assignments; ms per move or sweep, the acceptance.
6k. samplers  -- every random.py sampler at 1,048,576 draws (the Wishart
                 family at 65,536 of d = 2-4), z-tested against closed forms
                 (|z| < 5); the stick sampler at 1M rows x 1024 against the
                 host-seated sequential law by the table count over 16
                 draws each; le_sample_assignments at 300 items; each
                 model's sample_group(65,536) against its own predictive
                 (testing.sample_group_z); draws/s of each.
6l. main_orbax -- run_gibbs(use_pallas=True, checkpoint_format='orbax')
                 on nich2 at full width from the generating labels, 4
                 sweeps with a checkpoint every 2: stopped at sweep 2 and
                 resumed against the uninterrupted run, bitwise; a crash
                 left in the middle of the overwrite (only a complete
                 .tmp-orbax) recovered and resumed from, bitwise; the run
                 fed RowSharded values on a 2-shard in-process mesh
                 against the run fed the full values on it, bitwise; save
                 and load seconds and the directory's bytes.
6m. backends  -- the gradient and particle backends: the mixture log-prob
                 and its gradient at the suite's shape (262,144 rows x K 64
                 x 2 nich) against a float64 CPU evaluation (value 1e-4
                 relative, each gradient leaf 1e-3 in norm); hmc (100 +
                 100 iterations, 16 leapfrog steps; accept rate > 0.3),
                 nuts (max_depth 5, 30 + 30) and advi (300 steps) at that
                 shape, finite; the CPU tests' bb and nich conjugate checks
                 and HMC's blob purity on the card's RNG; smc_init at 2048
                 rows x 256 particles x capacity 32 (counts sum to R, the
                 best particle equals state_from_assignments) and SMC's
                 evidence of 5 rows within 0.02 of exact enumeration;
                 anneal at 1,048,576 rows x 1024 slots (tile 65,536, passes
                 4: every row assigned, counts equal the bincount); then the
                 suite's backends section at its defaults.
6n. facades  -- the rest of the public surface, as a user drives it:
                 each model's EXAMPLES[0] through the compat facade on the
                 card (scores equal to the CPU facade's within 1e-5, gp and
                 bnb at atol 2e-3 / 5e-4; 1000 Sampler.evals; ms of an
                 add_value + score_value row op); tests/test_compat.py's
                 per-row driver loop on 2000 rows x 2 nich of 80 blobs, at
                 most 64 groups, PitmanYor {2, 0.1} (counts equal the
                 bincount; ms a row); FeatureMixture.score_value over 1024 nich groups
                 against nich.score_value on the CPU within 1e-4 (256
                 values; ms a call); the protobuf codec on every model and
                 both priors (bytes equal to the CPU objects', loads back
                 onto the card equal; us a dump and a load);
                 examples/mixture/main_torch.py at its own scale (10,000
                 points, capacity 768, 10 passes, all five strategies; the
                 row-by-row sequential, seq-gibbs and smc cut to 2,000
                 points for time: counts sum to the rows, 64 x 64 uint8
                 images; seconds and components each);
                 examples/gmm_backends_torch.py at 512 rows, its chains cut
                 (HMC 100 + 100, NUTS 40 + 40, ADVI 300; seconds and
                 purity per backend, purity above 0.9 for collapsed
                 gibbs, mh, smc and advi, above 0.6 for hmc and nuts).
7. kernels    -- one line listing each ported kernel (K1-K5, B1-B5, and
                 K1's and K2's stat stages, which run inside every launch
                 of K1 and K2) with its launches on its main path, its
                 time, its twin's time, its nominal bound (data-sheet
                 rates, a log as one operation), its measured bound (the
                 roofline phase's rates, each op kind at its own rate),
                 the library call's time where one PyTorch call computes
                 the same and, for a kernel redesigned after its port, the
                 design it has now; K1 and K2 also give their launches in
                 main_le, K1-K4 theirs in reference_configs and their ms
                 at 8192 slots.

The entry points are called without a device, so they run on the package's
default device, the card.  The last line is {"ok": true, "device": {...}}.
There is no CPU path: the script fails when torch.cuda.is_available() is
false.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# flagship configuration: benchmarks/bench_runner.py (nich, 2 features)
ROWS = 1048576
SLOTS = 1024
FEATURES = 2
BLOCK = 131072
# nich column groups off the main path: the ragged K1 case again in two
# blocks, which takes the wide shape of the split walk
WIDE_GROUPS = (2, 3)
# the mixed path's tile (profile_mixed.py)
BLOCK_MIXED = 65536
TRUE_CLUSTERS = SLOTS // 8 * 7
SHARED = {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}
PY = {'alpha': 1.0, 'd': 0.1}
# run_gibbs on the main path: the first step captures the sweep graph,
# the second is timed, the last is profiled
STEPS = 3
SWEEPS_PER_STEP = 10
# stat sums: f32 sums of up to a few hundred rows per slot, summed in
# another order than the twin's matmul
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3
# the kernels of K1's and K2's stat stage, by the profiler's names
STAT_KERNELS = ('stat_partials', 'stat_reduce')
# a mismatched draw must be a near-tie: score gap at f32 rounding level
TIE_GAP = 1e-4
Z_MAX = 5.0
# NVIDIA H100 SXM data sheet: device memory rate and f32 rate outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# the same data sheet: dense bf16 on the tensor cores
PEAK_BF16_PER_S = 989e12
# the roofline entry point's default sizes (benchmarks/roofline.py)
COPY_MB = 512
CHAIN_SHAPE = (4096, 1024)
CHAIN_T = 256
MMA_N = 1024
MMA_STEPS = 512
# the suite's kernel_sampler sizes (benchmarks/suite.py); the one timed
SAMPLER_SIZES = (256, 1024, 4096)
SAMPLER_TIMED = 1024


T0 = time.time()


def emit(obj):
    """Print a result line; a phase's line also gives the seconds since
    the script started."""
    if 'phase' in obj:
        obj = dict(obj, script_seconds=round(time.time() - T0, 1))
    print(json.dumps(obj), flush=True)


def smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, batch=1):
    """The entry points' timing on the card: median milliseconds of `fn`
    over `reps` runs by CUDA events, after one warm-up run."""
    from distributions_tpu_torch.benchmarks.timing import median_ms
    return median_ms(fn, reps, 'cuda', batch)


def flagship_data():
    """bench_runner.py's data: 7C/8 true clusters, 0.1 noise, seed 0."""
    import numpy as np
    rng = np.random.RandomState(0)
    labels = rng.randint(0, TRUE_CLUSTERS, ROWS)
    centers = rng.randn(TRUE_CLUSTERS, FEATURES).astype(np.float32)
    X = centers[labels] + 0.1 * rng.randn(ROWS, FEATURES).astype(np.float32)
    return X.astype(np.float32), labels.astype(np.int32)


def nominal_bound(nbytes, n_ops, peak_ops=PEAK_F32_PER_S):
    """(milliseconds, 'bytes' | 'operations'): the larger of `nbytes` over
    the data sheet's memory rate and `n_ops` over its operation rate."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / peak_ops
    if by_ops >= by_bytes:
        return by_ops, 'operations'
    return by_bytes, 'bytes'


def bounds(port, tensors, counts, B, C):
    """The least time the card could take for one launch, twice over.

    Nominal (`bound_ms`, `bound_by`): the larger of the bytes it must move
    (every input read once, every output written once) over the data
    sheet's memory rate, and its f32 operations over the data sheet's f32
    rate, each log counted as one operation and the integer work of Philox
    not at all.

    Measured (`measured_bound_ms`, `measured_bound_by`): the same bytes
    over the copy rate the roofline phase measured (B4), and the operations
    per (row, slot) cell by kind (`counts`), each kind at the rate the
    roofline phase measured for it (B2), a Philox block among them."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    cells = float(B) * C
    n_ops = sum(n for kind, n in counts.items() if kind != 'philox')
    bound, bound_by = nominal_bound(nbytes, cells * n_ops)
    rates = port['rates']
    by_bytes = 1e3 * nbytes / rates['bytes_per_sec']
    by_ops = 1e3 * cells * sum(n * rates['sec_per'][kind]
                               for kind, n in counts.items())
    return {'bound_ms': bound, 'bound_by': bound_by,
            'measured_bound_ms': max(by_ops, by_bytes),
            'measured_bound_by': 'operations' if by_ops >= by_bytes
            else 'bytes', 'ops_per_cell': counts}


# the draw of one cell in 'gumbel' mode: m * 2^-24, log, negate, max, log,
# subtract, compare; a Philox4x32-10 block serves four cells
DRAW_OPS = {'simple': 5, 'log': 2, 'philox': 0.25}


def gumbel_ops_per_cell(col_groups, quad_groups, n_tab, log='log'):
    """Operations per cell in 'gumbel' mode by kind, from the inner loops
    of csrc/fused_v2.cu and csrc/fused_v3.cu: 'simple' (an add, subtract,
    multiply, max or compare), `log` ('log': the accurate logf; 'fast_log'
    in the '_fast' modes) and 'philox' (blocks)."""
    simple = logs = 0
    for nc in col_groups:
        # per column sub, mul, mul, add; the product chain; per chunk of 4
        # columns log, mul, add
        chunks = (nc + 3) // 4
        simple += 4 * nc + (nc - chunks) + 2 * chunks
        logs += chunks
    for nc, d in quad_groups:
        tri = d * (d + 1) // 2
        chunks = (nc + 3) // 4
        # per column d subs, 2 muls per term, tri - 1 adds, 1 + q
        simple += nc * (d + 2 * tri + (tri - 1) + 1) + (nc - chunks) \
            + 2 * chunks
        logs += chunks
    return {'simple': simple + n_tab + DRAW_OPS['simple'],
            log: logs + DRAW_OPS['log'], 'philox': DRAW_OPS['philox']}


def v1_ops_per_cell(cols, n_tab):
    """Operations per cell of csrc/score_sample_v1.cu in 'gumbel' mode by
    kind: per nich column sub, mul, mul, log1p, mul, add, add; one add per
    table column; the draw."""
    return {'simple': 6 * cols + n_tab + DRAW_OPS['simple'], 'log1p': cols,
            'log': DRAW_OPS['log'], 'philox': DRAW_OPS['philox']}


def phase_build(fk):
    t0 = time.time()
    infos = fk.build_all()
    out = {'phase': 'build', 'seconds': round(time.time() - t0, 3)}
    for name, info in infos.items():
        regs = sorted({int(line.split('Used ')[1].split(' ')[0])
                       for line in info['report'].splitlines()
                       if 'Used ' in line})
        spills = sorted({int(line.split(' bytes spill stores')[0].split()[-1])
                         for line in info['report'].splitlines()
                         if 'spill stores' in line})
        out[name] = {'nvcc_seconds': round(info['seconds'], 3),
                     'registers': regs, 'spill_store_bytes': spills,
                     'library': os.path.relpath(info['path'], HERE)}
    emit(out)


class Case:
    """One kernel at one set of inputs: how to launch it, its twin, the
    twin's [B, C] scores, and the twin's stat sums of given draws."""

    # modes held to the twin draw for draw, modes with the RNG in the
    # kernel (z-tests), modes checked for bitwise repeatability, modes timed
    det_modes = ('argmax', 'argmax_fast', 'gumbel_host', 'cdf_host')
    rng_modes = ('gumbel', 'cdf', 'gumbel_fast')
    repeat_modes = ('gumbel', 'cdf', 'argmax')
    time_modes = ('gumbel', 'gumbel_fast', 'cdf', 'argmax', 'gumbel_host',
                  'cdf_host')
    ragged_modes = ('argmax', 'gumbel_host', 'cdf_host')
    # K1 and K2 take their seed from device memory too (the form a CUDA
    # graph of the runner's sweep replays): held bitwise to the by-value
    # launch in these modes (the split walk and the sequential 'cdf' walk)
    # and timed in the timed ones
    pointer_modes = ('gumbel', 'gumbel_fast', 'cdf', 'argmax')
    pointer_timed = ('gumbel', 'cdf')

    def __init__(self, name, B, C, launch, plain, scores, sums_of, exact):
        self.name, self.B, self.C = name, B, C
        self.launch, self.plain = launch, plain
        self.scores, self.sums_of = scores, sums_of
        # indices (into the outputs after the draws) that must be exactly
        # equal: integer count tables
        self.exact = exact


class V1Case(Case):
    """K4 or K5: draws only, 'gumbel' | 'argmax' | 'gumbel_host'; the
    seed from device memory (the v1 sweeps' CUDA graph) held bitwise to
    the by-value launch and timed in turns with it in 'gumbel' and
    'argmax'."""
    det_modes = ragged_modes = ('argmax', 'gumbel_host')
    rng_modes = ('gumbel',)
    repeat_modes = ('gumbel', 'argmax')
    time_modes = ('gumbel', 'argmax', 'gumbel_host')
    pointer_modes = pointer_timed = ('gumbel', 'argmax')


def k1_case(port, values, cl_scores, coeffs, groups=None):
    import torch
    fk, base = port['fk'], port['base']
    groups = groups or (values.shape[1],)
    C = cl_scores.shape[0]

    def launch(mode, noise, seed):
        return fk.fused_score_sample_stats(seed, values, cl_scores, coeffs,
                                           groups, sampling=mode, noise=noise)

    def plain(mode, noise, seed):
        return fk.fused_score_sample_stats_plain(
            seed, values, cl_scores, coeffs, groups, sampling=mode,
            noise=noise)

    def scores():
        return fk._score_nich_product(values, coeffs, cl_scores, groups,
                                      torch.log)

    def sums_of(draws):
        stats = torch.cat([torch.ones_like(values), values, values * values],
                          1)
        return (base.segment_sum(stats, draws, C),)
    return Case('K1', values.shape[0], C, launch, plain, scores, sums_of, ())


def mixed_inputs(port, kind, B, C, n_clusters, seed=0):
    """A mixed problem on the card (default device) and K2's inputs for
    its first B rows against the state of all its rows."""
    import torch
    mx, cl, testing = port['mx'], port['cl'], port['testing']
    problem = testing.mixed_problem(B, C, seed=seed, kind=kind,
                                    n_clusters=n_clusters)
    spec, py, shareds = testing.build_problem(
        problem, port['models'], mx.make_spec, cl.PitmanYor.from_dict)
    dev = py.alpha.device
    values = tuple(torch.from_numpy(v).to(dev) for v in problem['values'])
    return tile_inputs(port, spec, py, shareds, values,
                       torch.from_numpy(problem['labels']).to(dev), B)


def tile_inputs(port, spec, py, shareds, values, labels, B):
    """K2's (and K3's) inputs for the first B rows of a problem on the
    card, against the state that `labels` give all its rows."""
    mx, cl, gibbs = port['mx'], port['cl'], port['gibbs']
    state = mx.state_from_assignments(spec, py, shareds, values, labels)
    lay = gibbs._mixed_static_layout(spec, values)
    lay = lay._replace(**{
        k: None if getattr(lay, k) is None else getattr(lay, k)[:B]
        .contiguous() for k in ('nich_vals', 'quad_vals', 'table_idx')})
    coeffs, qcoeffs, tables = gibbs._build_fused_inputs(spec, lay, shareds,
                                                        state)
    cl_scores = cl.score_value(py, state.counts, state.alive,
                               state.sample_size)
    col_groups = tuple(spec.blocks[i].cols for i in lay.nich_blocks)
    return dict(spec=spec, py=py, shareds=shareds, state=state, values=values,
                lay=lay, coeffs=coeffs, qcoeffs=qcoeffs, tables=tables,
                cl_scores=cl_scores, col_groups=col_groups)


def tile_rows(lay):
    """The rows of a fused layout's tile."""
    return next(x for x in (lay.table_idx, lay.quad_vals, lay.nich_vals)
                if x is not None).shape[0]


def k2_case(port, m):
    import torch
    fk = port['fk']
    lay = m['lay']
    C = m['cl_scores'].shape[0]
    B = tile_rows(lay)
    args = (lay.nich_vals, lay.table_idx, m['cl_scores'], m['coeffs'],
            m['tables'], m['col_groups'])
    kwargs = dict(qvalues=lay.quad_vals, qcoeffs=m['qcoeffs'],
                  quad_groups=lay.quad_groups, table_vs=lay.table_vs)

    def launch(mode, noise, seed):
        return fk.fused_mixed_score_sample_stats(seed, *args, sampling=mode,
                                                 noise=noise, **kwargs)

    def plain(mode, noise, seed):
        return fk.fused_mixed_score_sample_stats_plain(
            seed, *args, sampling=mode, noise=noise, **kwargs)

    def scores():
        return fk._score_mixed(B, lay.nich_vals, lay.table_idx,
                               m['cl_scores'], m['coeffs'], m['tables'],
                               m['col_groups'], lay.quad_vals, m['qcoeffs'],
                               lay.quad_groups, lay.table_vs, torch.log)

    def sums_of(draws):
        return fk._mixed_stat_sums(draws, C, lay.nich_vals, lay.table_idx,
                                   m['col_groups'], lay.quad_vals,
                                   lay.quad_groups, lay.table_vs)
    return Case('K2', B, C, launch, plain, scores, sums_of, (1,))


def host_noise(port, B, C, seed):
    import torch
    dev = port['config'].default_device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {'gumbel_host': port['random'].gumbel_noise(gen, (B, C), dev),
            'cdf_host': torch.rand((B, 1), generator=gen, device=dev)}


def compare_mode(port, case, mode, noise, seed=7):
    """A kernel against its twin on the same inputs: draw mismatches (must
    be near-ties) and the stat sums against the twin's contraction of the
    kernel's own draws."""
    import torch
    out_k = case.launch(mode, noise, seed)
    torch.cuda.synchronize()
    a_t = case.plain(mode, noise, seed)[0]
    scores = case.scores()
    if mode.startswith('gumbel_host'):
        scores = scores + noise
    n_bad, gap = port['testing'].mismatches(scores, out_k[0], a_t)
    del scores
    err = 0.0
    sums_ok = True
    for i, (got, ref) in enumerate(zip(out_k[1:], case.sums_of(out_k[0]))):
        if got.shape != ref.shape:
            raise AssertionError('%s %s: output %d has shape %s, twin %s'
                                 % (case.name, mode, i, tuple(got.shape),
                                    tuple(ref.shape)))
        if got.numel() == 0:
            continue
        err = max(err, float((got - ref).abs().max()))
        if i in case.exact:
            sums_ok = sums_ok and bool(torch.equal(got, ref))
        else:
            sums_ok = sums_ok and bool(torch.allclose(
                got, ref, rtol=SUM_RTOL, atol=SUM_ATOL))
    if mode.startswith('cdf'):
        # a cdf draw has no score gap: bound the count instead
        tie_ok = n_bad <= case.B // 10000
    else:
        tie_ok = gap <= TIE_GAP
    if not (tie_ok and sums_ok):
        raise AssertionError('%s %s disagrees with its twin: %d draws differ '
                             '(gap %g), sums err %g, sums ok %s'
                             % (case.name, mode, n_bad, gap, err, sums_ok))
    return {'mismatched_draws': n_bad, 'max_tie_gap': gap,
            'sums_max_abs_err': err}


def check_case(port, case, ref_scores, noise):
    """The checks one kernel is held to at one set of inputs.  Returns
    (per-mode results, largest stat-sum error, timings)."""
    import torch
    testing = port['testing']
    modes = {}
    max_err = 0.0
    for mode in case.det_modes:
        r = compare_mode(port, case, mode, noise.get(mode))
        max_err = max(max_err, r['sums_max_abs_err'])
        modes[mode] = r

    # in-kernel RNG: slot frequencies against the softmax of score_batch
    for mode in case.rng_modes:
        a = case.launch(mode, None, 12345)[0]
        z = testing.softmax_ztest(a, ref_scores)
        if not z < Z_MAX:
            raise AssertionError('%s %s draws fail the z-test: max |z| %g'
                                 % (case.name, mode, z))
        modes.setdefault(mode, {})['max_abs_z'] = z

    # two identical launches are bitwise equal
    for mode in case.repeat_modes:
        one = case.launch(mode, None, 99)
        two = case.launch(mode, None, 99)
        if not all(torch.equal(x, y) for x, y in zip(one, two)):
            raise AssertionError('%s %s is not bitwise repeatable'
                                 % (case.name, mode))

    # the seed read from device memory gives the by-value launch's outputs
    dev = ref_scores.device
    for mode in case.pointer_modes:
        one = case.launch(mode, None, 99)
        two = case.launch(mode, None, torch.tensor([99], device=dev))
        if not all(torch.equal(x, y) for x, y in zip(one, two)):
            raise AssertionError('%s %s: the seed pointer changes the '
                                 'outputs' % (case.name, mode))
        modes.setdefault(mode, {})['seed_pointer_bitwise'] = True

    # median milliseconds, kernel against twin, per mode; K1 and K2 also
    # with the seed in device memory
    timing = {}
    seed_t = torch.tensor([3], device=dev)
    for mode in case.time_modes:
        nz = noise.get(mode)
        timing[mode] = {
            'ms': cuda_ms(lambda: case.launch(mode, nz, 3), 7),
            'plain_ms': cuda_ms(lambda: case.plain(mode, nz, 3), 3)}
        if mode in case.pointer_timed:
            # in turns with the by-value launch: value, pointer, pointer,
            # value
            ptr = [cuda_ms(lambda: case.launch(mode, nz, seed_t), 7)
                   for _ in range(2)]
            val = [timing[mode]['ms'],
                   cuda_ms(lambda: case.launch(mode, nz, 3), 7)]
            timing[mode].update(ms_seed_pointer=sum(ptr) / 2,
                                ms_by_value=sum(val) / 2,
                                turns_ms={'by_value': val,
                                          'seed_pointer': ptr})
    return modes, max_err, timing


def philox_exact(port, name, launch, scores, B, C, slot_offset=0, seed=21,
                 fast_modes=True):
    """The kernel's own Philox noise, exactly: 'gumbel' draws against
    'gumbel_host' draws on fused_kernels.philox_gumbel_noise at the same
    seed (counter (row, g / 4), word g % 4, g = slot_offset + slot), and
    the same for their '_fast' forms unless `fast_modes` is false (K4 and
    K5 have none).  Only near-ties may differ (torch.log against the
    kernel's logf).  `launch(sampling, noise, seed)` returns the draws;
    `scores(fast)` the [B, C] scores."""
    fk, testing = port['fk'], port['testing']
    out = {}
    for fast in (False, True) if fast_modes else (False,):
        noise = fk.philox_gumbel_noise(seed, B, C, slot_offset=slot_offset,
                                       fast=fast)
        suffix = '_fast' if fast else ''
        a = launch('gumbel' + suffix, None, seed)
        b = launch('gumbel_host' + suffix, noise, seed)
        n_bad, gap = testing.mismatches(scores(fast) + noise, a, b)
        del noise
        if gap > TIE_GAP:
            raise AssertionError(
                '%s gumbel%s is not its Philox noise: %d draws differ from '
                'gumbel_host on philox_gumbel_noise (gap %g)'
                % (name, suffix, n_bad, gap))
        out['gumbel' + suffix] = {'mismatched_draws': n_bad,
                                  'max_tie_gap': gap}
    return out


def split_report(port, name, B, C, col_groups, quad_groups=(), table_vs=(),
                 sampling='gumbel', phase=0):
    """The split kernel that the launch takes: registers, local bytes,
    shared memory, record floats, turns, resident blocks per SM, and from
    them the occupancy (resident threads over the SM's maximum) and the
    waves of the launch's grid."""
    import torch
    fk = port['fk']
    r = fk.split_occupancy(name, C, col_groups, quad_groups, table_vs,
                           sampling, phase)
    props = torch.cuda.get_device_properties(0)
    block_rows = fk.SPLIT_THREADS // fk.SPLIT_SLICES * fk.SPLIT_ROWS
    blocks = -(-B // block_rows)
    resident = r['blocks_per_sm'] * props.multi_processor_count
    r.update(occupancy=r['blocks_per_sm'] * r['threads_per_block']
             / props.max_threads_per_multi_processor,
             grid_blocks=blocks, waves=blocks / max(resident, 1))
    return r


def split_ptxas(port, source):
    """-Xptxas -v over every instantiation of the split walk in
    csrc/<source>.cu: how many, their registers, and those that spill."""
    lines = ptxas_report(port['fk'], source, 'split_score_sample')
    regs = [int(line.split('Used ')[1].split(' ')[0]) for line in lines
            if 'Used ' in line]
    spills = [line for line in lines
              if 'spill' in line and not line.startswith('0 bytes stack')
              and ' 0 bytes spill stores' not in line]
    return {'instantiations': len(regs), 'registers_min': min(regs),
            'registers_max': max(regs), 'spill_lines': spills}


def check_ragged(port, case, noise):
    out = {}
    max_err = 0.0
    for mode in case.ragged_modes:
        r = compare_mode(port, case, mode, noise.get(mode))
        max_err = max(max_err, r['sums_max_abs_err'])
        out[mode] = r
    return out, max_err


def nich_inputs(port, values, labels, C, groups=None):
    """(spec, shareds, py, state, cl_scores, coeffs) of a nich mixture
    built from data, on the default device: one nich block of all the
    columns, or a block per entry of `groups`."""
    import torch
    mx, cl, nich, fk = port['mx'], port['cl'], port['nich'], port['fk']
    groups = groups or (values.shape[1],)
    spec = mx.make_spec([(nich, c) for c in groups], capacity=C)
    shareds = tuple(nich.shared_from_dict(SHARED) for _ in groups)
    py = cl.PitmanYor.from_dict(PY)
    cuts = [sum(groups[:i]) for i in range(len(groups) + 1)]
    state = mx.state_from_assignments(
        spec, py, shareds,
        tuple(values[:, a:b].contiguous() for a, b in zip(cuts, cuts[1:])),
        torch.as_tensor(labels, device=values.device))
    cl_scores = cl.score_value(py, state.counts, state.alive,
                               state.sample_size)
    coeffs = torch.cat([fk.nich_coeffs_v2(shareds[i], state.groups[i])
                        for i in range(len(groups))]).contiguous()
    return spec, shareds, py, state, cl_scores, coeffs


def phase_kernel(port, X, labels):
    import torch
    mx = port['mx']
    dev = port['config'].default_device()
    B = BLOCK
    all_values = torch.as_tensor(X, device=dev)
    values = all_values[:B].contiguous()
    spec, shareds, py, state, cl_scores, coeffs = nich_inputs(
        port, all_values, labels, SLOTS)
    case = k1_case(port, values, cl_scores, coeffs)
    ref_scores = mx.score_batch(spec, py, shareds, state, (values,))
    modes, max_err, timing = check_case(port, case, ref_scores,
                                        host_noise(port, B, SLOTS, 11))
    del ref_scores

    # ragged slots and rows
    Br, Cr = 3000, 1000
    ragged_vals = values[:Br].contiguous()
    _, _, _, _, cl_r, co_r = nich_inputs(port, ragged_vals,
                                         labels[:Br] % 900, Cr)
    ragged, err_r = check_ragged(port, k1_case(port, ragged_vals, cl_r, co_r),
                                 host_noise(port, Br, Cr, 5))
    max_err = max(max_err, err_r)
    # the same rows in two nich blocks of (2, 3) columns: the wide shape
    wide_vals = torch.cat([ragged_vals, 0.5 * ragged_vals + 1.0,
                           ragged_vals[:, :1] - 1.0], 1).contiguous()
    _, _, _, _, cl_w, co_w = nich_inputs(port, wide_vals, labels[:Br] % 900,
                                         Cr, WIDE_GROUPS)
    ragged_wide, err_w = check_ragged(
        port, k1_case(port, wide_vals, cl_w, co_w, WIDE_GROUPS),
        host_noise(port, Br, Cr, 6))
    max_err = max(max_err, err_w)
    philox = philox_exact(
        port, 'K1', lambda mode, nz, seed: case.launch(mode, nz, seed)[0],
        lambda fast: port['fk']._score_nich_product(
            values, coeffs, cl_scores, (FEATURES,),
            port['fk'].fast_log if fast else torch.log), B, SLOTS)
    tensors = (values, cl_scores, coeffs, torch.empty(B, dtype=torch.int32),
               torch.empty(SLOTS, 3 * FEATURES))
    bd = bounds(port, tensors, gumbel_ops_per_cell((FEATURES,), (), 0), B,
                SLOTS)
    bd_fast = bounds(port, tensors,
                     gumbel_ops_per_cell((FEATURES,), (), 0, 'fast_log'), B,
                     SLOTS)
    emit(dict({'phase': 'kernel', 'B': B, 'C': SLOTS, 'cols': FEATURES,
               'modes': modes, 'bitwise_repeatable': True, 'ragged': ragged,
               'ragged_wide': ragged_wide, 'philox_exact': philox,
               'timing': timing,
               'split': split_report(port, 'fused_v2', B, SLOTS,
                                     (FEATURES,)),
               'split_wide': split_report(port, 'fused_v2', Br, Cr,
                                          WIDE_GROUPS),
               'split_ptxas': split_ptxas(port, 'fused_v2'),
               'gumbel_fast_measured_bound_ms': bd_fast['measured_bound_ms']},
              **bd))
    # the main path's launch takes its seed from device memory
    return dict(bd, max_abs_err=max_err,
                ms=timing['gumbel']['ms_seed_pointer'],
                ms_by_value=timing['gumbel']['ms_by_value'],
                plain_ms=timing['gumbel']['plain_ms'])


def phase_kernel_k2(port):
    import torch
    mx = port['mx']
    B, C = BLOCK_MIXED, SLOTS
    result = {'phase': 'kernel_k2', 'B': B, 'C': C, 'layouts': {}}
    summary = None
    max_err = 0.0
    for kind in ('niw2mix', 'bbddgp'):
        m = mixed_inputs(port, kind, B, C, TRUE_CLUSTERS)
        case = k2_case(port, m)
        ref_scores = mx.score_batch(m['spec'], m['py'], m['shareds'],
                                    m['state'], m['values'])
        modes, err, timing = check_case(port, case, ref_scores,
                                        host_noise(port, B, C, 13))
        del ref_scores
        max_err = max(max_err, err)
        lay = m['lay']
        fk = port['fk']
        philox = philox_exact(
            port, 'K2 ' + kind,
            lambda mode, nz, seed: case.launch(mode, nz, seed)[0],
            lambda fast: fk._score_mixed(
                B, lay.nich_vals, lay.table_idx, m['cl_scores'], m['coeffs'],
                m['tables'], m['col_groups'], lay.quad_vals, m['qcoeffs'],
                lay.quad_groups, lay.table_vs,
                fk.fast_log if fast else torch.log), B, C)
        qdim = fk.quad_stat_dim(lay.quad_groups)
        bd = bounds(
            port,
            (lay.nich_vals, lay.quad_vals, lay.table_idx, m['cl_scores'],
             m['coeffs'], m['qcoeffs'], m['tables'],
             torch.empty(B, dtype=torch.int32),
             torch.empty(C, 3 * sum(m['col_groups']) + qdim
                         + sum(lay.table_vs))),
            gumbel_ops_per_cell(m['col_groups'], lay.quad_groups,
                                len(lay.table_vs)), B, C)
        result['layouts'][kind] = dict(
            {'modes': modes, 'timing': timing, 'bitwise_repeatable': True,
             'table_vs': list(lay.table_vs), 'philox_exact': philox,
             'split': split_report(port, 'fused_v3', B, C, m['col_groups'],
                                   lay.quad_groups, lay.table_vs)}, **bd)
        if kind == 'niw2mix':
            summary = dict(bd, ms=timing['gumbel']['ms_seed_pointer'],
                           ms_by_value=timing['gumbel']['ms_by_value'],
                           plain_ms=timing['gumbel']['plain_ms'])
        del m, case

    # ragged slots and rows, niw d=3 + nich + bb
    Br, Cr = 3000, 1000
    m = mixed_inputs(port, 'niw3_nich_bb', Br, Cr, 40, seed=4)
    result['ragged'], err = check_ragged(port, k2_case(port, m),
                                         host_noise(port, Br, Cr, 5))
    result['split_wide'] = split_report(port, 'fused_v3', Br, Cr,
                                        m['col_groups'], m['lay'].quad_groups,
                                        m['lay'].table_vs)
    summary['max_abs_err'] = max(max_err, err)
    result['split_ptxas'] = split_ptxas(port, 'fused_v3')
    emit(result)
    return summary


# -- K1's and K2's stat stage alone ------------------------------------------

STAT_TIMED_ROWS = (16384, 65536, 131072)
STAT_SLOTS = (1024, 8192)
STAT_GRAPH_REPS = 20
STAT_CASES = ('one', 'uniform', 'pitman_yor', 'outside', 'draws')


def pitman_yor_slots(B, C, seed):
    """B slots drawn from the stick-breaking weights of a Pitman-Yor
    {alpha 1, d 0.1} partition cut to C slots (numpy, seeded): a few
    slots take most rows."""
    import numpy as np
    rng = np.random.RandomState(seed)
    k = np.arange(1, C + 1)
    v = rng.beta(1.0 - PY['d'], PY['alpha'] + k * PY['d'])
    w = v * np.concatenate([[1.0], np.cumprod(1.0 - v)[:-1]])
    return rng.choice(C, B, p=w / w.sum()).astype(np.int32)


def stat_slots(port, kind, B, C, draws):
    """The slots of one stat-stage case, int32 [B] on the card: every row
    in one slot, uniform over C, Pitman-Yor-skewed, a quarter outside
    [0, C) (some far out), or `draws` (the kernel's own 'gumbel' draws of
    the main path's tile)."""
    import torch
    dev = port['config'].default_device()
    gen = torch.Generator(device=dev).manual_seed(B + C)
    if kind == 'one':
        return torch.full((B,), C // 3, dtype=torch.int32, device=dev)
    if kind == 'uniform':
        return torch.randint(0, C, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    if kind == 'pitman_yor':
        return torch.from_numpy(pitman_yor_slots(B, C, B + C)).to(dev)
    if kind == 'outside':
        a = torch.randint(-C // 8, C + C // 8, (B,), generator=gen,
                          device=dev, dtype=torch.int32)
        a[::7] = -1000000
        a[1::11] = C + 100000
        return a
    return draws[:B].contiguous()


def graph_replay(fn, reps):
    """A CUDA graph of `reps` calls of fn() (one eager call first) and the
    outputs of its last call."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            out = fn()
    return g, out


def graph_ms(fn, names=STAT_KERNELS):
    """(milliseconds a call by CUDA events over replays of a graph of
    STAT_GRAPH_REPS calls, device milliseconds a call of the kernels
    named `names` by the profiler over one replay; with names=None every
    device kernel counts)."""
    reps = STAT_GRAPH_REPS
    g, _ = graph_replay(fn, reps)
    g.replay()
    ms = cuda_ms(g.replay, 5) / reps
    prof = profile_sweep(g.replay, names or ('',))
    dev_ms = prof.get('kernel_device_ms')
    return ms, (dev_ms / reps if isinstance(dev_ms, float) else dev_ms)


def stat_check(port, what, launch, plain, exact):
    """The stage against its twin on one case (float sums within
    SUM_RTOL / SUM_ATOL, the outputs in `exact` equal), two launches
    bitwise equal, and a replay of a CUDA graph of it bitwise equal to an
    eager launch.  Returns the largest difference from the twin."""
    import torch
    got = launch()
    want = plain()
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape:
            raise AssertionError('%s: output %d has shape %s, twin %s'
                                 % (what, i, tuple(a.shape), tuple(b.shape)))
        if a.numel() == 0:
            continue
        err = max(err, float((a - b).abs().max()))
        ok = (torch.equal(a, b) if i in exact else
              bool(torch.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL)))
        if not ok:
            raise AssertionError('%s: output %d disagrees with the twin '
                                 '(max abs err %g)' % (what, i, err))
    again = launch()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError('%s is not bitwise repeatable' % what)
    g, replayed = graph_replay(launch, 1)
    g.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, replayed)):
        raise AssertionError('%s: a graph replay differs from the eager '
                             'launch' % what)
    return err


def phase_kernel_stats(port, X, labels):
    """K1's and K2's stat stage (csrc/fused_stats.cuh) alone, through
    bench_kernels.stat_sums / mixed_stat_sums: against their twins, twice
    bitwise, and replayed from a CUDA graph bitwise, in every case of
    STAT_CASES at C = 1024 and 8192, ragged B, and K2 on count tables
    alone; then its time at STAT_TIMED_ROWS beside the twin and
    torch.Tensor.index_add_ of the prebuilt features."""
    import torch
    fk, bk, mx = port['fk'], port['bk'], port['mx']
    dev = port['config'].default_device()
    B = STAT_TIMED_ROWS[-1]
    t0 = time.time()
    values = torch.as_tensor(X[:B], device=dev)
    _, _, _, _, cl_scores, coeffs = nich_inputs(
        port, torch.as_tensor(X, device=dev), labels, SLOTS)
    draws1 = fk.fused_score_sample_stats(3, values, cl_scores, coeffs,
                                         (FEATURES,), sampling='gumbel')[0]
    k2in = {kind: mixed_inputs(port, kind, B, SLOTS, TRUE_CLUSTERS)
            for kind in ('niw2mix', 'bbddgp')}
    draws2 = {}
    for kind, m in k2in.items():
        case = k2_case(port, m)
        draws2[kind] = case.launch('gumbel', None, 3)[0]

    def k1_fns(B, C, a):
        v = values[:B]
        return (lambda: (bk.stat_sums(v, a, C),),
                lambda: (bk.stat_sums_plain(v, a, C),))

    def k2_fns(kind, B, C, a):
        lay = k2in[kind]['lay']

        def rows(t):
            return None if t is None else t[:B].contiguous()
        args = (rows(lay.nich_vals), rows(lay.quad_vals),
                rows(lay.table_idx), a, C, k2in[kind]['col_groups'],
                lay.quad_groups, lay.table_vs)
        return (lambda: bk.mixed_stat_sums(*args),
                lambda: bk.mixed_stat_sums_plain(*args))

    result = {'phase': 'kernel_stats', 'cases': {}}
    max_err = {'K1': 0.0, 'K2': 0.0}
    checks = []
    for C in STAT_SLOTS:
        for kind in STAT_CASES:
            if kind == 'draws' and C != SLOTS:
                continue
            checks.append((C, kind, B))
        checks.append((C, 'uniform', B - 77))
        checks.append((C, 'pitman_yor', 3001))
    for C, kind, rows in checks:
        a1 = stat_slots(port, kind, rows, C, draws1)
        err = stat_check(port, 'K1 stat stage %s B=%d C=%d' % (kind, rows, C),
                         *k1_fns(rows, C, a1), ())
        max_err['K1'] = max(max_err['K1'], err)
        result['cases']['K1 %s %d x %d' % (kind, rows, C)] = err
        for layout in ('niw2mix', 'bbddgp'):
            a2 = stat_slots(port, kind, rows, C, draws2[layout])
            err = stat_check(
                port, 'K2 stat stage %s %s B=%d C=%d' % (layout, kind, rows,
                                                         C),
                *k2_fns(layout, rows, C, a2), (1,))
            if layout == 'niw2mix':
                max_err['K2'] = max(max_err['K2'], err)
            result['cases']['K2 %s %s %d x %d' % (layout, kind, rows,
                                                  C)] = err
    result['check_seconds'] = round(time.time() - t0, 1)

    # times a launch: the stage (CUDA events over graph replays; the
    # profiler's device time of its two kernels), the twin, index_add_
    timing = {}
    lay2 = k2in['niw2mix']['lay']
    groups2 = k2in['niw2mix']['col_groups']
    for rows in STAT_TIMED_ROWS:
        for name in ('K1', 'K2'):
            if name == 'K1':
                a = draws1[:rows].contiguous()
                kern, plain = k1_fns(rows, SLOTS, a)
                v = values[:rows]
                feats = torch.cat([torch.ones_like(v), v, v * v], 1)
                plan = fk.stat_plan('fused_v2', rows, SLOTS, (FEATURES,))
            else:
                a = draws2['niw2mix'][:rows].contiguous()
                kern, plain = k2_fns('niw2mix', rows, SLOTS, a)
                v = lay2.nich_vals[:rows]
                feats = torch.cat(
                    [torch.ones_like(v), v, v * v, fk._quad_stat_features(
                        lay2.quad_vals[:rows], lay2.quad_groups)], 1)
                plan = fk.stat_plan('fused_v3', rows, SLOTS, groups2,
                                    lay2.quad_groups, lay2.table_vs)
            ms, dev_ms = graph_ms(kern)
            # the one PyTorch call that sums the prebuilt features per
            # slot (with float atomics)
            acc = torch.zeros((SLOTS, feats.shape[1]), device=dev)
            idx = a.long()
            lib_ms, lib_dev_ms = graph_ms(
                lambda: acc.index_add_(0, idx, feats), names=None)
            timing['%s %d' % (name, rows)] = {
                'ms': ms, 'device_ms': dev_ms, 'plain_ms': cuda_ms(plain, 3),
                'library_ms': lib_ms, 'library_device_ms': lib_dev_ms,
                'plan': plan}
    # at 8192 slots against 1024, uniform slots: (ms, device ms)
    for C in STAT_SLOTS:
        for rows in (STAT_TIMED_ROWS[0], STAT_TIMED_ROWS[-1]):
            a = stat_slots(port, 'uniform', rows, C, None)
            timing['K1 %d x %d uniform' % (rows, C)] = graph_ms(
                k1_fns(rows, C, a)[0])
            timing['K2 %d x %d uniform' % (rows, C)] = graph_ms(
                k2_fns('niw2mix', rows, C, a)[0])
    result['timing'] = timing
    result['seconds'] = round(time.time() - t0, 1)

    # the kernels line's figures at the main path's tiles
    out = {}
    for name, rows in (('K1', BLOCK), ('K2', BLOCK_MIXED)):
        t = timing['%s %d' % (name, rows)]
        if name == 'K1':
            tensors = (values[:rows], draws1[:rows],
                       torch.empty(SLOTS, 3 * FEATURES))
        else:
            tensors = (lay2.nich_vals[:rows], lay2.quad_vals[:rows],
                       lay2.table_idx[:rows], draws2['niw2mix'][:rows],
                       torch.empty(SLOTS, 3 * sum(groups2)
                                   + fk.quad_stat_dim(lay2.quad_groups)
                                   + sum(lay2.table_vs)))
        # bytes: each input read once, each output written once; the
        # arithmetic (a few adds a feature a row) is negligible
        nbytes = sum(x.numel() * x.element_size() for x in tensors)
        bound, bound_by = nominal_bound(nbytes, 0)
        out[name] = {'ms': t['ms'], 'device_ms': t['device_ms'],
                     'plain_ms': t['plain_ms'],
                     'library_ms': t['library_ms'], 'bound_ms': bound,
                     'bound_by': bound_by,
                     'measured_bound_ms':
                         1e3 * nbytes / port['rates']['bytes_per_sec'],
                     'measured_bound_by': 'bytes', 'rows': rows,
                     'bytes': nbytes, 'max_abs_err': max_err[name]}
    result['summary'] = out
    result['stat_sums_launches'] = bk.stat_sums.launches
    result['mixed_stat_sums_launches'] = bk.mixed_stat_sums.launches
    emit(result)
    return out


def v1_case(port, name, nich_vals, idx, cl_scores, coeffs, tables):
    """K4 (name 'K4': nich columns only, through nich_score_sample) or K5
    (through mixed_score_sample) at one set of inputs.  The outputs are
    1-tuples, so that the checks written for K1 and K2 apply."""
    import torch
    fk = port['fk']
    B = (nich_vals if nich_vals is not None else idx).shape[0]
    if tables is not None:
        tables = torch.clamp(tables, min=-1e30)
    if name == 'K4':
        args = (nich_vals, cl_scores, coeffs)
        wrapper, twin = fk.nich_score_sample, fk.nich_score_sample_plain
    else:
        args = (nich_vals, idx, cl_scores, coeffs, tables)
        wrapper, twin = fk.mixed_score_sample, fk.mixed_score_sample_plain

    def launch(mode, noise, seed):
        return (wrapper(seed, *args, sampling=mode, noise=noise),)

    def plain(mode, noise, seed):
        return (twin(seed, *args, sampling=mode, noise=noise),)

    def scores():
        return fk._score_v1(B, nich_vals, idx, cl_scores, coeffs, tables)
    return V1Case(name, B, cl_scores.shape[0], launch, plain, scores,
                  lambda draws: (), ())


def v1_philox_exact(port, case):
    """philox_exact of K4 or K5 at one set of inputs (`v1_case`)."""
    return philox_exact(
        port, case.name, lambda mode, nz, seed: case.launch(mode, nz, seed)[0],
        lambda fast: case.scores(), case.B, case.C, fast_modes=False)


def v1_mixed_inputs(port, m):
    """K5's per-slot inputs (coeffs, tables) for the problem `mixed_inputs`
    built."""
    return port['gibbs']._build_v1_inputs(m['spec'], m['lay'], m['shareds'],
                                          m['state'])


def v1_bounds(port, tensors, cols, n_tab, B, C):
    import torch
    return bounds(port,
                  tuple(tensors) + (torch.empty(B, dtype=torch.int32),),
                  v1_ops_per_cell(cols, n_tab), B, C)


def phase_kernel_k4(port, X, labels):
    import torch
    mx, fk = port['mx'], port['fk']
    dev = port['config'].default_device()
    B = BLOCK
    all_values = torch.as_tensor(X, device=dev)
    values = all_values[:B].contiguous()
    spec, shareds, py, state, cl_scores, _ = nich_inputs(
        port, all_values, labels, SLOTS)
    coeffs = fk.nich_coeffs(shareds[0], state.groups[0]).contiguous()
    case = v1_case(port, 'K4', values, None, cl_scores, coeffs, None)
    ref_scores = mx.score_batch(spec, py, shareds, state, (values,))
    modes, _, timing = check_case(port, case, ref_scores,
                                  host_noise(port, B, SLOTS, 11))
    del ref_scores
    Br, Cr = 3000, 1000
    ragged_vals = values[:Br].contiguous()
    _, sh_r, _, st_r, cl_r, _ = nich_inputs(port, ragged_vals,
                                            labels[:Br] % 900, Cr)
    co_r = fk.nich_coeffs(sh_r[0], st_r.groups[0]).contiguous()
    ragged_case = v1_case(port, 'K4', ragged_vals, None, cl_r, co_r, None)
    ragged, _ = check_ragged(port, ragged_case, host_noise(port, Br, Cr, 5))
    # the same rows in one block of 5 columns: the split walk's wide shape
    wide_vals = torch.cat([ragged_vals, 0.5 * ragged_vals + 1.0,
                           ragged_vals[:, :1] - 1.0], 1).contiguous()
    wide_cols = wide_vals.shape[1]
    _, sh_w, _, st_w, cl_w, _ = nich_inputs(port, wide_vals,
                                            labels[:Br] % 900, Cr)
    co_w = fk.nich_coeffs(sh_w[0], st_w.groups[0]).contiguous()
    wide_case = v1_case(port, 'K4', wide_vals, None, cl_w, co_w, None)
    ragged_wide, _ = check_ragged(port, wide_case,
                                  host_noise(port, Br, Cr, 6))
    philox = {'main': v1_philox_exact(port, case),
              'ragged': v1_philox_exact(port, ragged_case),
              'ragged_wide': v1_philox_exact(port, wide_case)}
    bd = v1_bounds(port, (values, cl_scores, coeffs), FEATURES, 0, B, SLOTS)
    emit(dict({'phase': 'kernel_k4', 'B': B, 'C': SLOTS, 'cols': FEATURES,
               'modes': modes, 'bitwise_repeatable': True, 'ragged': ragged,
               'ragged_wide': ragged_wide, 'philox_exact': philox,
               'timing': timing,
               'split': split_report(port, 'score_sample_v1', B, SLOTS,
                                     (FEATURES,)),
               'split_wide': split_report(port, 'score_sample_v1', Br, Cr,
                                          (wide_cols,)),
               'split_ptxas': split_ptxas(port, 'score_sample_v1')}, **bd))
    # draws only: the error against the twin is the count of draws that
    # differ, 0 or the check above has raised; the main path's launch (the
    # v1 sweep's graph) takes its seed from device memory
    return dict(bd, max_abs_err=float(max(r['mismatched_draws']
                                          for r in modes.values()
                                          if 'mismatched_draws' in r)),
                ms=timing['gumbel']['ms_seed_pointer'],
                ms_by_value=timing['gumbel']['ms_by_value'],
                plain_ms=timing['gumbel']['plain_ms'])


def phase_kernel_k5(port):
    mx = port['mx']
    B, C = BLOCK_MIXED, SLOTS
    result = {'phase': 'kernel_k5', 'B': B, 'C': C, 'layouts': {}}
    summary = None
    worst = 0
    for kind in ('nichbbddgp', 'bbddgp'):
        m = mixed_inputs(port, kind, B, C, TRUE_CLUSTERS)
        lay = m['lay']
        coeffs, tables = v1_mixed_inputs(port, m)
        case = v1_case(port, 'K5', lay.nich_vals, lay.table_idx,
                       m['cl_scores'], coeffs, tables)
        ref_scores = mx.score_batch(m['spec'], m['py'], m['shareds'],
                                    m['state'], m['values'])
        modes, _, timing = check_case(port, case, ref_scores,
                                      host_noise(port, B, C, 13))
        del ref_scores
        worst = max([worst] + [r['mismatched_draws'] for r in modes.values()
                               if 'mismatched_draws' in r])
        cols = 0 if lay.nich_vals is None else lay.nich_vals.shape[1]
        philox = v1_philox_exact(port, case)
        bd = v1_bounds(
            port,
            (lay.nich_vals, lay.table_idx, m['cl_scores'], coeffs, tables),
            cols, len(lay.table_vs), B, C)
        result['layouts'][kind] = dict(
            {'modes': modes, 'timing': timing, 'bitwise_repeatable': True,
             'tables': list(tables.shape), 'philox_exact': philox,
             'split': split_report(port, 'score_sample_v1', B, C,
                                   (cols,) if cols else (), (),
                                   lay.table_vs)}, **bd)
        if kind == 'nichbbddgp':
            summary = dict(bd, ms=timing['gumbel']['ms_seed_pointer'],
                           ms_by_value=timing['gumbel']['ms_by_value'],
                           plain_ms=timing['gumbel']['plain_ms'])
        del m, case

    # ragged slots and rows, on nich + gp + bb and on dd + bb, and on
    # random inputs of 3 nich and 5 table columns (the wide shape)
    Br, Cr = 3000, 1000
    result['ragged'], result['philox_exact_ragged'] = {}, {}
    wide = (3, 5, 6)
    for kind in ('nich_gp_bb', 'dd_bb', 'wide'):
        if kind == 'wide':
            case = v1_case(port, 'K5', *port['testing'].v1_random_inputs(
                Br, Cr, *wide, seed=8,
                device=port['config'].default_device()))
        else:
            m = mixed_inputs(port, kind, Br, Cr, 40, seed=4)
            coeffs, tables = v1_mixed_inputs(port, m)
            case = v1_case(port, 'K5', m['lay'].nich_vals,
                           m['lay'].table_idx, m['cl_scores'], coeffs, tables)
        result['ragged'][kind], _ = check_ragged(port, case,
                                                 host_noise(port, Br, Cr, 5))
        result['philox_exact_ragged'][kind] = v1_philox_exact(port, case)
        worst = max([worst] + [r['mismatched_draws']
                               for r in result['ragged'][kind].values()])
    result['split_wide'] = split_report(port, 'score_sample_v1', Br, Cr,
                                        wide[:1], (), (wide[2],) * wide[1])
    summary['max_abs_err'] = float(worst)
    emit(result)
    return summary


def slot_slice(m, a, b, noise=None):
    """K3's arguments for slots [a, b) of the K2 problem `m`: (args,
    kwargs) of fused_score_sample_pair without seed and sampling."""
    import torch
    lay = m['lay']

    def cut(x):
        return None if x is None else x[:, a:b].contiguous()
    tables = m['tables']
    if tables is not None:
        tables = torch.clamp(tables, min=-1e30)
    args = (lay.nich_vals, lay.table_idx, m['cl_scores'][a:b].contiguous(),
            cut(m['coeffs']), cut(tables), m['col_groups'])
    kwargs = dict(qvalues=lay.quad_vals, qcoeffs=cut(m['qcoeffs']),
                  quad_groups=lay.quad_groups, table_vs=lay.table_vs,
                  noise=cut(noise), slot_offset=a,
                  total_slots=m['cl_scores'].shape[0])
    return args, kwargs


def pair_reduce(pairs, offsets, C):
    """The reduce of the component-sharded sweeps: the largest best and, at
    equal best, the lowest global slot."""
    import torch
    best = torch.stack([p[1] for p in pairs])
    ids = torch.stack([p[0].long() + o for p, o in zip(pairs, offsets)])
    top = best.max(0).values
    return torch.where(best == top, ids,
                       torch.full_like(ids, C)).min(0).values.to(torch.int32)


def check_pair_shards(port, m, cuts, noise, z_scores):
    """K3 over the slot ranges `cuts` of the K2 problem `m`: each shard
    against its twin, the reduced shards against K2 on the whole slot axis,
    z-tests and repeatability.  Returns (per-mode results, largest error of
    a best score)."""
    import torch
    fk, testing = port['fk'], port['testing']
    lay = m['lay']
    C = m['cl_scores'].shape[0]
    B = tile_rows(lay)
    k2_args = (lay.nich_vals, lay.table_idx, m['cl_scores'], m['coeffs'],
               m['tables'], m['col_groups'])
    k2_kwargs = dict(qvalues=lay.quad_vals, qcoeffs=m['qcoeffs'],
                     quad_groups=lay.quad_groups, table_vs=lay.table_vs)
    spans = list(zip(cuts[:-1], cuts[1:]))
    modes = {}
    best_err = 0.0
    for mode in ('argmax', 'argmax_fast', 'gumbel_host', 'gumbel',
                 'gumbel_fast'):
        nz = noise if mode == 'gumbel_host' else None
        pairs, n_bad, gap, bitwise = [], 0, 0.0, True
        for a, b in spans:
            args, kwargs = slot_slice(m, a, b, nz)
            got = fk.fused_score_sample_pair(7, *args, sampling=mode,
                                             **kwargs)
            again = fk.fused_score_sample_pair(7, *args, sampling=mode,
                                               **kwargs)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])):
                raise AssertionError('K3 %s is not bitwise repeatable' % mode)
            pairs.append(got)
            if mode in ('gumbel', 'gumbel_fast'):
                continue
            want = fk.fused_score_sample_pair_plain(7, *args, sampling=mode,
                                                    **kwargs)
            scores = fk._score_mixed(
                B, *args, kwargs['qvalues'], kwargs['qcoeffs'],
                kwargs['quad_groups'], kwargs['table_vs'],
                fk.fast_log if mode.endswith('_fast') else torch.log)
            if nz is not None:
                scores = scores + kwargs['noise']
            bad, g = testing.mismatches(scores, got[0], want[0])
            del scores
            n_bad += bad
            gap = max(gap, g)
            # equal values (also two -inf: a shard of dead slots) are no error
            err = torch.where(got[1] == want[1], torch.zeros_like(want[1]),
                              (got[1] - want[1]).abs())
            best_err = max(best_err, float(err.max()))
            bitwise = bitwise and bool(torch.equal(got[1], want[1]))
            if gap > TIE_GAP or not bool(
                    (err <= 1e-6 + 1e-6 * want[1].abs()).all()):
                raise AssertionError(
                    'K3 %s slots [%d, %d) disagrees with its twin: %d draws '
                    'differ (gap %g), best err %g' % (mode, a, b, bad, g,
                                                      float(err.max())))
        r = {}
        if mode not in ('gumbel', 'gumbel_fast'):
            r.update(mismatched_draws=n_bad, max_tie_gap=gap,
                     best_bitwise_equal=bitwise)
        reduced = pair_reduce(pairs, cuts[:-1], C)
        if mode in ('argmax', 'gumbel_host', 'gumbel'):
            whole = fk.fused_mixed_score_sample_stats(
                7, *k2_args, sampling=mode, noise=nz, **k2_kwargs)[0]
            r['reduced_shards_differ_from_k2'] = int((reduced != whole).sum())
            if r['reduced_shards_differ_from_k2']:
                raise AssertionError(
                    'K3 %s: the reduced shards differ from K2 on the whole '
                    'slot axis in %d rows'
                    % (mode, r['reduced_shards_differ_from_k2']))
        if mode in ('gumbel', 'gumbel_fast') and z_scores is not None:
            r['max_abs_z'] = testing.softmax_ztest(reduced, z_scores)
            if not r['max_abs_z'] < Z_MAX:
                raise AssertionError('K3 %s draws fail the z-test: max |z| %g'
                                     % (mode, r['max_abs_z']))
        modes[mode] = r
    return modes, best_err


def phase_kernel_k3(port):
    import torch
    fk, mx = port['fk'], port['mx']
    B, C, n_comp = BLOCK_MIXED, SLOTS, 4
    CL = C // n_comp
    cuts = tuple(range(0, C + 1, CL))
    result = {'phase': 'kernel_k3', 'B': B, 'C_local': CL, 'shards': n_comp,
              'layouts': {}}
    summary = None
    worst = 0.0
    for kind in ('niw2mix', 'bbddgp'):
        m = mixed_inputs(port, kind, B, C, TRUE_CLUSTERS)
        lay = m['lay']
        noise = host_noise(port, B, C, 13)['gumbel_host']
        ref_scores = mx.score_batch(m['spec'], m['py'], m['shareds'],
                                    m['state'], m['values'])
        modes, err = check_pair_shards(port, m, cuts, noise, ref_scores)
        del ref_scores
        worst = max(worst, err)
        philox = {}
        for a, b in zip(cuts[:-1], cuts[1:]):
            s_args, s_kwargs = slot_slice(m, a, b)
            s_kwargs.pop('noise')

            def launch(mode, nz, seed):
                return fk.fused_score_sample_pair(
                    seed, *s_args, sampling=mode, noise=nz, **s_kwargs)[0]

            def scores(fast):
                return fk._score_mixed(
                    B, *s_args, s_kwargs['qvalues'], s_kwargs['qcoeffs'],
                    s_kwargs['quad_groups'], s_kwargs['table_vs'],
                    fk.fast_log if fast else torch.log)
            philox['slot_offset_%d' % a] = philox_exact(
                port, 'K3 %s [%d, %d)' % (kind, a, b), launch, scores, B,
                b - a, slot_offset=a)
        timing = {}
        seed_t = torch.tensor([3], device=m['cl_scores'].device)
        for mode in ('gumbel', 'gumbel_fast', 'argmax', 'gumbel_host'):
            args, kwargs = slot_slice(
                m, 0, CL, noise if mode == 'gumbel_host' else None)

            def launch(seed=3):
                return fk.fused_score_sample_pair(seed, *args, sampling=mode,
                                                  **kwargs)

            def plain():
                return fk.fused_score_sample_pair_plain(
                    3, *args, sampling=mode, **kwargs)
            timing[mode] = {'ms': cuda_ms(launch, 7),
                            'plain_ms': cuda_ms(plain, 3)}
            if mode == 'gumbel_host':
                continue
            # the seed read from device memory (the form the 2-D sweep's
            # CUDA graph replays) gives the by-value launch's outputs
            if not all(torch.equal(x, y) for x, y in zip(
                    launch(), launch(seed_t))):
                raise AssertionError('K3 %s %s: the seed pointer changes '
                                     'the outputs' % (kind, mode))
            timing[mode]['seed_pointer_bitwise'] = True
            # in turns with the by-value launch: value, pointer, pointer,
            # value
            ptr = [cuda_ms(lambda: launch(seed_t), 7) for _ in range(2)]
            val = [timing[mode]['ms'], cuda_ms(launch, 7)]
            timing[mode].update(ms_seed_pointer=sum(ptr) / 2,
                                ms_by_value=sum(val) / 2,
                                turns_ms={'by_value': val,
                                          'seed_pointer': ptr})
        args, kwargs = slot_slice(m, 0, CL)
        ops = gumbel_ops_per_cell(m['col_groups'], lay.quad_groups,
                                  len(lay.table_vs))
        bd = bounds(
            port,
            (lay.nich_vals, lay.quad_vals, lay.table_idx) + args[2:5]
            + (kwargs['qcoeffs'], torch.empty(B, dtype=torch.int32),
               torch.empty(B)), ops, B, CL)
        entry = dict({'modes': modes, 'timing': timing,
                      'bitwise_repeatable': True, 'philox_exact': philox,
                      'split': split_report(port, 'fused_v3', B, CL,
                                            m['col_groups'], lay.quad_groups,
                                            lay.table_vs)}, **bd)
        if kind == 'niw2mix':
            # one launch over the whole slot axis
            w_args, w_kwargs = slot_slice(m, 0, C)
            one, _ = check_pair_shards(port, m, (0, C), noise, None)
            fk.fused_score_sample_pair(3, *w_args, sampling='gumbel',
                                       **w_kwargs)
            w_bd = bounds(
                port,
                (lay.nich_vals, lay.quad_vals, lay.table_idx) + w_args[2:5]
                + (w_kwargs['qcoeffs'], torch.empty(B, dtype=torch.int32),
                   torch.empty(B)), ops, B, C)
            entry['whole_slot_axis'] = dict(
                {'C_local': C, 'modes': one,
                 'gumbel_ms': cuda_ms(lambda: fk.fused_score_sample_pair(
                     3, *w_args, sampling='gumbel', **w_kwargs), 7)}, **w_bd)
            summary = dict(bd, ms=timing['gumbel']['ms_seed_pointer'],
                           ms_by_value=timing['gumbel']['ms_by_value'],
                           plain_ms=timing['gumbel']['plain_ms'])
        result['layouts'][kind] = entry
        del m

    # ragged rows and slots, slot ranges at odd offsets, niw d=3 + nich + bb
    Br, Cr = 3000, 1000
    m = mixed_inputs(port, 'niw3_nich_bb', Br, Cr, 40, seed=4)
    result['ragged'], err = check_pair_shards(
        port, m, (0, 333, 335, Cr), host_noise(port, Br, Cr, 5)['gumbel_host'],
        None)
    summary['max_abs_err'] = max(worst, err)
    emit(result)
    return summary


def ptxas_report(fk, source, kernel):
    """The `-Xptxas -v` lines of one kernel of csrc/<source>.cu (its entry
    functions' mangled names hold len(kernel) + kernel), from the build's
    log: the 'Used ...' line and the stack and spill line of each."""
    lines = fk.build(source)['report'].splitlines()
    tag = '%d%s' % (len(kernel), kernel)
    out, keep = [], False
    for line in lines:
        if 'Compiling entry function' in line:
            keep = tag in line
        elif keep and ('Used ' in line or 'spill' in line):
            out.append(line.strip())
    return out


def phase_kernel_b4(port):
    """B4, the streamed copy, at the roofline entry point's 512 MB, and at
    lengths around its chunk and ring and with ragged tails."""
    import torch
    bk = port['bk']
    lengths = (5, (1 << 16) + 3) + bk.COPY_EDGE_LENGTHS + ((1 << 20) - 1,
                                                           (1 << 20) + 1)
    dev = port['config'].default_device()
    n = COPY_MB * (1 << 20) // 4
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    got = bk.roofline_copy(x)
    torch.cuda.synchronize()
    want = bk.roofline_copy_plain(x)
    err = float((got - want).abs().max())
    exact = bool(torch.equal(got, want)) and all(
        bool(torch.equal(bk.roofline_copy(x[:m]), bk.roofline_copy_plain(
            x[:m]))) for m in lengths)
    del got, want
    if not exact:
        raise AssertionError('B4 differs from x + 1 (max abs err %g)' % err)
    torch.add(x, 1)
    # 0.4 ms calls: timed back to back, as the roofline entry point times
    # them, so that the wrapper's tens of us of Python before each launch
    # do not count as the card's time
    batch = port['roofline'].COPY_BATCH
    ms = cuda_ms(lambda: bk.roofline_copy(x), 7, batch)
    plain_ms = cuda_ms(lambda: bk.roofline_copy_plain(x), 7, batch)
    library_ms = cuda_ms(lambda: torch.add(x, 1), 7, batch)
    single_ms = cuda_ms(lambda: bk.roofline_copy(x), 7)
    nbytes = 2.0 * n * 4
    bound, bound_by = nominal_bound(nbytes, n)
    out = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
           'library_ms': library_ms, 'bound_ms': bound, 'bound_by': bound_by,
           # the kernel is its own yardstick: its rate is the measured one
           'measured_bound_ms': ms, 'measured_bound_by': 'bytes'}
    emit(dict({'phase': 'kernel_b4', 'mb': COPY_MB, 'exact': exact,
               'lengths': list(lengths), 'batch': batch,
               'single_call_ms': single_ms,
               'bytes_per_sec': nbytes / (ms / 1e3),
               'share_of_bound': bound / ms,
               'library': 'torch.add(x, 1)',
               'library_bytes_per_sec': nbytes / (library_ms / 1e3),
               'ptxas': ptxas_report(port['fk'], 'roofline', 'roofline_copy')},
              **out))
    return out


def phase_kernel_b2(port):
    """B2, the dependent chain: every op and depth against the twin at a
    small T, then 'mul' (exact) and 'log' at the entry point's size."""
    import torch
    bk = port['bk']
    dev = port['config'].default_device()
    gen = torch.Generator(device=dev).manual_seed(2)
    small = torch.rand((64, 1024), generator=gen, device=dev) + 0.5
    per_op = {}
    for op in bk.CHAIN_OPS:
        worst = 0.0
        for K in (1, 5, 9):
            got = bk.roofline_chain(small, op, 3, K)
            want = bk.roofline_chain_plain(small, op, 3, K)
            worst = max(worst, float((got - want).abs().max()))
            if op in bk.CHAIN_EXACT_OPS:
                ok = bool(torch.equal(got, want))
            else:
                # CUDA's logf / expf / log1pf / rsqrtf against PyTorch's
                ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))
            if not ok:
                raise AssertionError('B2 %s K=%d disagrees with its twin '
                                     '(max abs err %g)' % (op, K, worst))
        per_op[op] = worst

    (rows, width), T, K = CHAIN_SHAPE, CHAIN_T, 9
    x = torch.randn((rows, width), generator=gen, device=dev).abs() + 0.5
    if not torch.equal(bk.roofline_chain(x, 'mul', T, K),
                       bk.roofline_chain_plain(x, 'mul', T, K)):
        raise AssertionError('B2 mul at full size differs from its twin')
    got = bk.roofline_chain(x, 'log', T, K)
    torch.cuda.synchronize()
    want = bk.roofline_chain_plain(x, 'log', T, K)
    err = float((got - want).abs().max())
    # 256 summed terms of a 9-deep chain whose map expands near 0: ulps of
    # logf may grow by two orders of magnitude
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-2):
        raise AssertionError('B2 log at full size: max abs err %g' % err)
    del got, want
    ms = cuda_ms(lambda: bk.roofline_chain(x, 'log', T, K), 5)
    plain_ms = cuda_ms(lambda: bk.roofline_chain_plain(x, 'log', T, K), 1)
    # per chain step the renorm's add and the log; y = x + i and the sum
    n_ops = float(rows) * width * T * (2 * K + 2)
    bound, bound_by = nominal_bound(2.0 * rows * width * 4, n_ops)
    out = {'max_abs_err': max(err, max(per_op.values())), 'ms': ms,
           'plain_ms': plain_ms, 'library_ms': None, 'bound_ms': bound,
           'bound_by': bound_by, 'measured_bound_ms': ms,
           'measured_bound_by': 'operations'}
    emit(dict({'phase': 'kernel_b2', 'small': {'shape': [64, 1024], 'T': 3,
                                               'K': [1, 5, 9],
                                               'max_abs_err': per_op},
               'timed': {'op': 'log', 'shape': [rows, width], 'T': T, 'K': K,
                         'max_abs_err': err},
               'exact_ops': list(bk.CHAIN_EXACT_OPS)}, **out))
    return out


def mma_exact(a, b, steps):
    """B3's function with float64 sums, acc rounded to bf16 once from
    them: exact but for that rounding."""
    import torch
    af, bf = a.double(), b.double()
    acc = af @ bf
    acc = acc + af @ acc.to(torch.bfloat16).double()
    out = torch.zeros_like(acc)
    for _ in range(steps):
        out = out + acc
    return out.float()


def mma_close(got, want, rms):
    """Normal operands: the tensor cores' f32 sums round acc to bf16 apart
    from the twin's where it lies near a rounding boundary, each such term
    moving an output by |a| x one bf16 ulp; held per element to 5e-3 of the
    result's rms and 1e-2 of the element, as tests/test_torch_cuda.py
    holds them."""
    return bool(((got - want).abs() <= 5e-3 * rms + 1e-2 * want.abs()).all())


def phase_kernel_b3(port):
    """B3, the tensor-core products, at the entry point's 1024^3: bitwise
    on integer operands (at 2048 too), every buffer written before it is
    read, normal operands and the timed call against the twin."""
    import torch
    bk, roofline = port['bk'], port['roofline']
    dev = port['config'].default_device()
    N, steps = MMA_N, MMA_STEPS
    gen = torch.Generator(device=dev).manual_seed(3)

    def operands(n, hi=None):
        def draw():
            if hi is None:
                return torch.randn((n, n), generator=gen, device=dev)
            return torch.randint(-hi, hi + 1, (n, n), generator=gen,
                                 device=dev)
        return draw().to(torch.bfloat16), draw().to(torch.bfloat16)

    # operands from {-hi, ..., hi}: every product and sum is an integer
    # below 2^24 that f32 holds exactly whatever the order of the sums, so
    # bf16(acc) rounds the same value in the kernel and the twin; from {-1,
    # 0, 1} |acc| stays below 256, where bf16 is exact, from {-4, ..., 4}
    # it often passes 256 and the rounding is held bitwise.  N = 2048 gives
    # more tiles than SMs.
    int_err = 0.0
    for n_int, st, hi in ((N, 1, 1), (N, 3, 4), (2 * N, 1, 4)):
        a, b = operands(n_int, hi)
        got = bk.roofline_mma(a, b, st)
        want = bk.roofline_mma_plain(a, b, st)
        int_err = max(int_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError('B3 on integer operands from {-%d..%d}, N=%d '
                                 'steps=%d, differs from its twin (max abs '
                                 'err %g)' % (hi, hi, n_int, st, int_err))
    # every buffer NaN and every strip counter -1 before the call: a read
    # before this call's write, or a counter left unzeroed, shows.  Each
    # accb buffer is first read at step 1 or 2; later steps compute the same
    # acc again, so a stale read there cannot show through this function.
    scratch = bk._mma_scratch

    def poisoned(n, d):
        bufs = scratch(n, d)
        for t in bufs[:3]:
            t.fill_(float('nan'))
        bufs[3].fill_(-1)
        return bufs
    bk._mma_scratch = poisoned
    try:
        got = bk.roofline_mma(a, b, 3)
    finally:
        bk._mma_scratch = scratch
    if not torch.equal(got, bk.roofline_mma_plain(a, b, 3)):
        raise AssertionError('B3 with its buffers poisoned differs from its '
                             'twin')
    # normal operands: the kernel, the twin and the exact function, each
    # distance as max abs / rms of the result
    normal = []
    for n, st in ((256, 1), (N, 2), (2 * N, 1)):
        a, b = operands(n)
        got = bk.roofline_mma(a, b, st)
        want = bk.roofline_mma_plain(a, b, st)
        exact = mma_exact(a, b, st)
        rms = float(want.pow(2).mean().sqrt())
        normal.append({
            'N': n, 'steps': st, 'result_rms': rms,
            'kernel_twin': float((got - want).abs().max()) / rms,
            'kernel_exact': float((got - exact).abs().max()) / rms,
            'twin_exact': float((want - exact).abs().max()) / rms})
        if not mma_close(got, want, rms):
            raise AssertionError('B3 on normal operands, N=%d steps=%d: %s'
                                 % (n, st, normal[-1]))
    err = normal[1]['kernel_twin'] * normal[1]['result_rms']
    del got, want, exact
    # the timed configuration, held to its twin
    a, b = operands(N)
    launches = bk.roofline_mma.launches
    got = bk.roofline_mma(a, b, steps)
    if bk.roofline_mma.launches != launches + 1:
        raise AssertionError('B3 is one launch a call')
    want = bk.roofline_mma_plain(a, b, steps)
    rms = float(want.pow(2).mean().sqrt())
    timed_err = float((got - want).abs().max())
    if not mma_close(got, want, rms):
        raise AssertionError('B3 at %d steps: max abs err %g (rms of the '
                             'result %g)' % (steps, timed_err, rms))
    del got, want
    ms = cuda_ms(lambda: bk.roofline_mma(a, b, steps), 3)
    plain_ms = cuda_ms(lambda: bk.roofline_mma_plain(a, b, steps), 1)
    # the yardstick: the same library calls replayed from one CUDA graph
    library_ms = roofline.matmul_graph_ms(a, b, 2 * steps, 3)
    flops = 4.0 * N ** 3 * steps
    bound, bound_by = nominal_bound(2.0 * N * N * 2 + N * N * 4, flops,
                                    PEAK_BF16_PER_S)
    out = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
           'library_ms': library_ms, 'bound_ms': bound, 'bound_by': bound_by,
           'measured_bound_ms': ms, 'measured_bound_by': 'operations'}
    emit(dict({'phase': 'kernel_b3', 'N': N, 'steps': steps,
               'launches_per_call': 1,
               'integer_operands_max_abs_err': int_err,
               'normal_operands': normal,
               'timed_call': {'max_abs_err': timed_err, 'result_rms': rms},
               'flops_per_sec': flops / (ms / 1e3),
               'share_of_bound': bound / ms,
               'library': '%d x torch.matmul(a, b, out=c) in one CUDA graph'
                          % (2 * steps),
               'library_flops_per_sec': flops / (library_ms / 1e3),
               'ptxas': ptxas_report(port['fk'], 'roofline', 'roofline_mma')},
              **out))
    return out


def phase_roofline(port):
    """The roofline entry point at its default sizes.  Leaves the measured
    rates in port['rates'] and returns the launches of B2, B3 and B4."""
    bk, roofline = port['bk'], port['roofline']
    wrappers = {'B2': bk.roofline_chain, 'B3': bk.roofline_mma,
                'B4': bk.roofline_copy}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    r = roofline.measure()
    seconds = time.time() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    detail = r.pop('detail')
    for op in roofline.OPS:
        d = detail[op]
        # the time is linear in the depth: the compiler kept every step
        if not (d['evals_per_sec'] > 0 and 0.3 < d['midpoint'] < 0.7):
            raise AssertionError('B2 %s: the time is not linear in the chain '
                                 'depth: %s' % (op, d))
    per = {op: 1.0 / r['vpu_%s_ops_per_sec' % op] for op in roofline.OPS}
    # seconds per evaluation by kind.  A chain step of log, log1p, rsqrt
    # and fast_log holds one add beside the op, of exp and fast_exp one
    # multiply, of a Philox block one of each: taken off.
    sec_per = {'simple': min(per['add'], per['mul'], per['fma']),
               'philox': per['philox'] - per['add'] - per['mul']}
    for op, renorm in (('log', 'add'), ('log1p', 'add'), ('rsqrt', 'add'),
                       ('fast_log', 'add'), ('exp', 'mul'),
                       ('fast_exp', 'mul')):
        sec_per[op] = per[op] - per[renorm]
    if min(sec_per.values()) <= 0:
        raise AssertionError('a measured op cost is not positive: %s'
                             % sec_per)
    port['rates'] = {'bytes_per_sec': r['hbm_bytes_per_sec'],
                     'sec_per': sec_per}
    emit(dict({'phase': 'roofline', 'seconds': round(seconds, 3),
               'launches': launches,
               'chain_ms': {op: detail[op]['ms'] for op in roofline.OPS},
               'chain_midpoint': {op: detail[op]['midpoint']
                                  for op in roofline.OPS},
               'mma': detail['mma'], 'hbm': detail['hbm'],
               'seconds_per_op': sec_per,
               'slots_per_op': {k: v / sec_per['simple']
                                for k, v in sec_per.items()}}, **r))
    return launches


def phase_kernel_phases(port):
    """The phase profiler's entry point, at its default single nich column
    and at the flagship's two.  Returns B5's launches."""
    bk, kp = port['bk'], port['kernel_phases']
    bk.fused_phase.launches = 0
    default = kp.run()
    flagship = kp.run(cols=FEATURES)
    launches = bk.fused_phase.launches
    # the phases that are not K1 itself ('full_*' goes through K1's wrapper)
    own = [m for m in kp.MODES if not m.startswith('full_')]
    want = sum(len(own) * r['tiles'] * (r['reps'] + 1)
               for r in (default, flagship))
    if launches != want:
        raise AssertionError('B5: %d launches, expected %d'
                             % (launches, want))
    ms = flagship['ms']
    cells = float(flagship['rows']) * flagship['cap']
    # what a Philox block costs in place, inside K1, beside the rate of
    # the generator alone (B2's 'philox' op)
    philox = 4.0 * (ms['score_bits'] - ms['score_max']) / 1e3 / cells
    if not (philox > 0 and ms['full_gumbel'] > ms['score_gumbel']
            > ms['score_bits'] > ms['score_max'] > ms['noop'] > 0):
        raise AssertionError('the cumulative phases do not take cumulative '
                             'time: %s' % ms)
    emit({'phase': 'kernel_phases', 'launches': launches,
          'cols_1': default, 'cols_%d' % FEATURES: flagship,
          'philox_in_k1_seconds_per_block': philox,
          'philox_alone_seconds_per_block':
              port['rates']['sec_per']['philox']})
    return launches


def phase_kernel_b5(port, X, labels):
    """B5 at K1's flagship tile: every phase against its twin or against
    K1 itself, and the phases' milliseconds."""
    import torch
    bk, fk = port['bk'], port['fk']
    dev = port['config'].default_device()
    B = BLOCK
    all_values = torch.as_tensor(X, device=dev)
    values = all_values[:B].contiguous()
    _, _, _, _, cl_scores, coeffs = nich_inputs(port, all_values, labels,
                                                SLOTS)
    args = (values, cl_scores, coeffs, (FEATURES,))
    checks = {}
    checks['noop_equal'] = bool(torch.equal(
        bk.fused_phase('noop', 0, *args),
        bk.fused_phase_plain('noop', 0, *args)))
    best = bk.fused_phase('score_max', 0, *args)
    want = bk.fused_phase_plain('score_max', 0, *args)
    best_err = float((best - want).abs().max())
    checks['score_max_bitwise_equal'] = bool(torch.equal(best, want))
    checks['score_max_within_1e-6'] = bool(
        ((best - want).abs() <= 1e-6 + 1e-6 * want.abs()).all())
    # 'score_bits' perturbs by at most BITS_NOISE_MAX: its pick scores
    # within that (and a rounding) of the row maximum
    scores = fk._score_nich_product(values, coeffs, cl_scores, (FEATURES,),
                                    torch.log)
    pick = bk.fused_phase('score_bits', 5, *args)
    top = scores.amax(1)
    gap = top - scores.gather(1, pick.long().clamp(0, SLOTS - 1)[:, None])[:, 0]
    del scores
    checks['score_bits_in_range'] = bool(
        int(pick.min()) >= 0 and int(pick.max()) < SLOTS)
    checks['score_bits_near_the_maximum'] = bool(
        (gap <= bk.BITS_NOISE_MAX + 1e-6 + 1e-6 * top.abs()).all())
    noise = host_noise(port, B, SLOTS, 11)['gumbel_host']
    for sampling, nz in (('argmax', None), ('gumbel_host', noise),
                         ('gumbel', None), ('cdf', None),
                         ('gumbel_fast', None)):
        a, s = fk.fused_score_sample_stats(5, *args, sampling=sampling,
                                           noise=nz)
        checks['score_%s_equals_k1' % sampling] = bool(torch.equal(
            bk.fused_phase('score_' + sampling, 5, *args, noise=nz), a))
        a2, s2 = bk.fused_phase('full_' + sampling, 5, *args, noise=nz)
        checks['full_%s_equals_k1' % sampling] = bool(
            torch.equal(a2, a) and torch.equal(s2, s))
    del noise
    if not all(v for k, v in checks.items()
               if k != 'score_max_bitwise_equal'):
        raise AssertionError('B5 disagrees: %s (score_max err %g)'
                             % (checks, best_err))
    timing = {}
    for phase in ('noop', 'score_max', 'score_bits', 'score_gumbel'):
        timing[phase] = cuda_ms(lambda: bk.fused_phase(phase, 3, *args), 7)
    plain_ms = cuda_ms(
        lambda: bk.fused_phase_plain('score_gumbel', 3, *args), 3)
    bd = bounds(port, (values, cl_scores, coeffs,
                       torch.empty(B, dtype=torch.int32)),
                gumbel_ops_per_cell((FEATURES,), (), 0), B, SLOTS)
    emit(dict({'phase': 'kernel_b5', 'B': B, 'C': SLOTS, 'cols': FEATURES,
               'checks': checks, 'score_max_max_abs_err': best_err,
               'timing_ms': timing, 'timed': 'score_gumbel'}, **bd))
    return dict(bd, max_abs_err=best_err, ms=timing['score_gumbel'],
                plain_ms=plain_ms)


def repeated_ztest(draws, scores, min_expected=20.0):
    """Largest |z| of the slot frequencies of draws [T, BR] (T independent
    draws of each row's categorical) against the softmax of scores
    [BR, C], over slots expecting more than `min_expected` draws."""
    import torch
    T = draws.shape[0]
    p = torch.softmax(scores.to(torch.float64), dim=1)
    counts = torch.bincount(draws.reshape(-1).long(),
                            minlength=p.shape[1]).to(torch.float64)
    expected = T * p.sum(0)
    var = torch.clamp(T * (p * (1 - p)).sum(0), min=1e-9)
    z = (counts - expected) / var.sqrt()
    return float(z[expected > min_expected].abs().max())


def phase_kernel_b1(port):
    """B1, the sampler alone, at the suite's sizes."""
    import torch
    bk = port['bk']
    dev = port['config'].default_device()
    rows = port['suite'].SAMPLER_ROWS
    gen = torch.Generator(device=dev).manual_seed(6)
    sizes = {}
    summary = None
    for C in SAMPLER_SIZES:
        scores = torch.randn((rows, C), generator=gen, device=dev)
        noise = host_noise(port, rows, C, 17)['gumbel_host']
        bad = 0
        for sampling, nz in (('argmax', None), ('gumbel_host', noise)):
            got = bk.sampler_gumbel(4, scores, 4, sampling, nz,
                                    all_draws=True)
            want = bk.sampler_gumbel_plain(4, scores, 4, sampling, nz,
                                           all_draws=True)
            bad += sum(int((x != y).sum()) for x, y in zip(got, want))
        if bad:
            raise AssertionError('B1 C=%d: %d draws or checksums differ from '
                                 'the twin' % (C, bad))
        T = 128
        last, checksum, draws = bk.sampler_gumbel(9, scores, T,
                                                  all_draws=True)
        again = bk.sampler_gumbel(9, scores, T, all_draws=True)
        consistent = (all(torch.equal(x, y) for x, y in zip(
            (last, checksum, draws), again))
            and torch.equal(last, draws[-1])
            and torch.equal(checksum, draws.sum(0).to(torch.int32))
            and not torch.equal(draws[0], draws[1]))
        z = repeated_ztest(draws, scores)
        if not (consistent and z < Z_MAX):
            raise AssertionError('B1 C=%d gumbel: consistent %s, max |z| %g'
                                 % (C, consistent, z))
        sizes[C] = {'mismatches': bad, 'max_abs_z': z, 'z_draws': rows * T,
                    'bitwise_repeatable': True}
        if C == SAMPLER_TIMED:
            # the suite's iteration count at this C: 2^28 cells a call
            T = max(16, (1 << 28) // (rows * C))
            ms = cuda_ms(lambda: bk.sampler_gumbel(3, scores, T), 7)
            plain_ms = cuda_ms(
                lambda: bk.sampler_gumbel_plain(3, scores, T), 2)
            bd = bounds(port, (scores, last, checksum), dict(DRAW_OPS),
                        rows * T, C)
            summary = dict(bd, max_abs_err=float(bad), ms=ms,
                           plain_ms=plain_ms, library_ms=None)
            sizes[C]['timed'] = {'iters': T, 'ms': ms, 'plain_ms': plain_ms}
    emit(dict({'phase': 'kernel_b1', 'rows': rows, 'sizes': sizes}, **bd))
    return summary


def phase_suite(port):
    """The suite's ported sections at their default sizes (each prints its
    own result lines).  Returns B1's launches."""
    bk, suite = port['bk'], port['suite']
    bk.sampler_gumbel.launches = 0
    sampler = suite.bench_kernel_sampler()
    launches = bk.sampler_gumbel.launches
    # one warm-up and three timed calls per size
    if launches != 4 * len(sampler):
        raise AssertionError('B1: %d launches, expected %d'
                             % (launches, 4 * len(sampler)))
    grid = suite.bench_hyper_grid()
    emit({'phase': 'suite', 'launches': launches,
          'kernel_sampler_elems_per_sec': {r['size']: r['elems_per_sec']
                                           for r in sampler},
          'hyper_grid_ms': grid[0]['ms'],
          'hyper_grid_cells_per_sec': grid[0]['value']})
    return launches


def phase_main_hypers(port, X, labels):
    """run_gibbs with hyperparameter moves through the normal entry point:
    nich2 at full width, a 64-point sigmasq grid and an 8 x 8 Pitman-Yor
    grid every 5 of 10 sweeps."""
    import numpy as np
    import torch
    fk, mx, hypers, nich = (port['fk'], port['mx'], port['hypers'],
                            port['nich'])
    dev = port['config'].default_device()
    spec = mx.make_spec([(nich, FEATURES)], capacity=SLOTS)
    shareds = (nich.shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    G = 64
    grid = nich.Shared(
        mu=torch.zeros(G, device=dev),
        kappa=torch.full((G,), SHARED['kappa'], device=dev),
        sigmasq=torch.as_tensor(np.logspace(-4, 0, G).astype(np.float32),
                                device=dev),
        nu=torch.ones(G, device=dev))
    cl_grid = hypers.make_py_grid(np.logspace(-1, 2, 8).astype(np.float32),
                                  np.linspace(0.0, 0.7, 8).astype(np.float32))
    passes, every = 10, 5
    torch.cuda.synchronize()
    fk.fused_score_sample_stats.launches = 0
    stats = graph_counts(port)
    t0 = time.time()
    state, an, log = port['runner'].run_gibbs(
        spec, py, shareds, (X,), torch.Generator().manual_seed(0), passes,
        block=BLOCK, use_pallas=True, sampling='gumbel',
        initial_assignments=labels, grow_headroom=0.0, sweeps_per_step=every,
        hyper_grids={0: grid}, cl_grid=cl_grid, hyper_every=every)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = expect_launches('run_gibbs(hyper_grids)',
                               fk.fused_score_sample_stats,
                               ROWS // BLOCK * passes)
    # the moves' new shareds and prior are copied into the graph's buffers
    graphs = expect_graph('run_gibbs(hyper_grids)', stats, passes,
                          passes // every)

    def point(g, i):
        return type(g)(*(leaf[i] for leaf in g))
    moves = [(r['sweep'], r.get('hyper_0'), r.get('hyper_cl'))
             for r in log.rows]
    sh_new, py_new = log.final_shareds, log.final_cl_model
    values = (torch.as_tensor(X, device=an.device),)
    # the last row was scored before its move, under the hyperparameters
    # chosen at the first edge
    run_checks, score = check_run(
        port, spec, point(cl_grid, moves[0][2]), (point(grid, moves[0][1]),),
        values, state, an, log)
    after = float(mx.score_data(spec, py_new, sh_new, state))
    fresh = float(mx.score_data(spec, py_new, sh_new,
                                mx.state_from_assignments(
                                    spec, py_new, sh_new, values, an)))
    last = moves[-1]
    checks = dict(
        run_checks,
        moves_at_the_edges=[m[0] for m in moves] == [every - 1, passes - 1],
        indices_in_range=all(0 <= m[1] < G and 0 <= m[2] < 64
                             for m in moves),
        final_shareds_are_the_logged_point=bool(
            torch.equal(sh_new[0].sigmasq, grid.sigmasq[last[1]])
            and torch.equal(py_new.alpha, cl_grid.alpha[last[2]])
            and torch.equal(py_new.d, cl_grid.d[last[2]])),
        score_after_equals_fresh=abs(after - fresh) <= 1e-4 * abs(fresh))
    if not all(checks.values()):
        raise AssertionError('main_hypers: %s (moves %s, score after %r, '
                             'fresh %r)' % (checks, moves, after, fresh))

    gen = torch.Generator().manual_seed(1)

    def wall_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.time() - t0))
        return sorted(times)[2]
    # a move as the runner makes it: the chosen index is read on the host
    feature_ms = wall_ms(lambda: int(hypers.grid_step_feature(
        gen, spec, 0, sh_new, state, grid)[1]))
    cl_ms = wall_ms(lambda: int(hypers.grid_step_clustering(
        gen, cl_grid, state)[1]))
    steps = [r['seconds'] for r in log.rows]
    emit({'phase': 'main_hypers', 'rows': ROWS, 'slots': SLOTS,
          'sweeps': passes, 'hyper_every': every, 'launches': launches,
          'graphs': graphs,
          'moves': [{'sweep': m[0], 'hyper_0': m[1], 'hyper_cl': m[2],
                     'sigmasq': float(grid.sigmasq[m[1]]),
                     'alpha': float(cl_grid.alpha[m[2]]),
                     'd': float(cl_grid.d[m[2]])} for m in moves],
          'grid_argmax': {
              'hyper_0': int(hypers.grid_step_feature(
                  gen, spec, 0, sh_new, state, grid, sample=False)[1]),
              'hyper_cl': int(hypers.grid_step_clustering(
                  gen, cl_grid, state, sample=False)[1])},
          'score_data_last_row': score, 'score_data_after_move': after,
          'fresh_score_data_after_move': fresh, 'checks': checks,
          'step_seconds': steps, 'wall_seconds': round(wall, 3),
          # the second step also rebuilds the stat cache after the move
          'ms_per_sweep_by_step': [1e3 * s / every for s in steps],
          'feature_grid_step_ms': feature_ms,
          'clustering_grid_step_ms': cl_ms})


def check_run(port, spec, py, shareds, values, state, assignments, log):
    """What comes out of a run is right: shapes, ranges, counts and a
    fresh score."""
    import numpy as np
    import torch
    mx = port['mx']
    a = assignments.cpu().numpy()
    counts = state.counts.cpu().numpy()
    score = log.rows[-1]['score_data']
    fresh = float(mx.score_data(spec, py, shareds, mx.state_from_assignments(
        spec, py, shareds, values, assignments)))
    checks = {
        'shape': a.shape == (ROWS,) and assignments.dtype == torch.int32,
        'range': bool((a >= 0).all() and (a < SLOTS).all()),
        'counts': bool((np.bincount(a, minlength=SLOTS) == counts).all()),
        'finite': bool(np.isfinite(score)),
        'fresh_score': abs(score - fresh) <= 1e-4 * abs(fresh),
        'capacity': state.counts.shape[0] == SLOTS,
        'on_the_card': assignments.device.type == 'cuda',
    }
    if not all(checks.values()):
        raise AssertionError('main path output is wrong: %s (score %r, '
                             'fresh %r)' % (checks, score, fresh))
    return checks, score


def graph_counts(port):
    """The graph path's counters (gibbs.GRAPH_STATS), set to 0."""
    return port['gibbs'].reset_graph_stats()


def expect_graph(what, stats, sweeps, steps, captures=1):
    """Every sweep of a run took the graph: the first sweep of each
    captured graph runs eagerly as its warm-up, every other one is a
    replay; likewise for the step's joint score."""
    want = {'captures': captures, 'replays': sweeps - captures,
            'score_captures': captures, 'score_replays': steps - captures}
    got = {k: stats[k] for k in want}
    if got != want:
        raise AssertionError('%s did not run every sweep from its CUDA '
                             'graph: %s, expected %s' % (what, got, want))
    return dict(got, capture_seconds=stats['capture_seconds'],
                pool_bytes=stats['pool_bytes'])


def run_main(port, wrapper, spec, py, shareds, values_np, labels, block,
             steps=STEPS, sweeps_per_step=SWEEPS_PER_STEP):
    """run_gibbs on numpy rows and labels with no device named, with the
    launch count of `wrapper` and the graph counters set to 0 just before
    and read just after."""
    import torch
    rows = len(labels)
    tiles = rows // block
    passes = steps * sweeps_per_step
    torch.cuda.synchronize()
    wrapper.launches = 0
    stats = graph_counts(port)
    log = last_step_profiler(port, steps, wrapper)
    t0 = time.time()
    state, assignments, log = port['runner'].run_gibbs(
        spec, py, shareds, values_np, torch.Generator().manual_seed(0),
        passes, block=block, use_pallas=True, sampling='gumbel',
        initial_assignments=labels, grow_headroom=0.0,
        sweeps_per_step=sweeps_per_step, log=log)
    torch.cuda.synchronize()
    wall = time.time() - t0
    last = log.stop()
    launches = wrapper.launches
    if launches != tiles * passes:
        raise AssertionError('%d kernel launches, expected tiles x sweeps '
                             '= %d' % (launches, tiles * passes))
    graphs = expect_graph('run_gibbs', stats, passes, steps)
    # the launches the wrapper counted in the last step, replays included,
    # against the kernels the device ran in it
    want = tiles * sweeps_per_step
    seen = last.get('kernel_calls', {}).get('split_score_sample')
    if not seen == last['launches_counted'] == want:
        raise AssertionError(
            'run_gibbs: in its last step the device ran %r score + sample '
            'kernels and the wrapper counted %d launches, expected tiles x '
            'sweeps = %d (profile: %s)' % (seen, last['launches_counted'],
                                           want, last))
    # and as many launches of the stat stage (csrc/fused_stats.cuh), which
    # K1 and K2 run after their draw
    stat_seen = last.get('stat_stage_calls', {}).get('stat_partials')
    if stat_seen != want:
        raise AssertionError(
            'run_gibbs: in its last step the device ran %r stat stages, '
            'expected tiles x sweeps = %d (profile: %s)'
            % (stat_seen, want, last))
    step_seconds = [r['seconds'] for r in log.rows]
    # steady steps: the first also builds the stat cache and captures the
    # graph, the last is profiled (of two steps, the profiled one)
    steady = step_seconds[1:-1] or step_seconds[1:]
    ms_sweep = 1e3 * sum(steady) / (sweeps_per_step * len(steady))
    return state, assignments, log, {
        'rows': rows, 'slots': spec.capacity, 'block': block,
        'sampling': 'gumbel', 'sweeps': passes,
        'sweeps_per_step': sweeps_per_step,
        'step_seconds': step_seconds, 'wall_seconds': round(wall, 3),
        'ms_per_sweep': ms_sweep, 'launches': launches, 'graphs': graphs,
        'last_step_profile': last,
        'busy_share_steady_step': last['device_busy_share'],
        'nonempty_groups': log.rows[-1]['nonempty_groups']}


# torch.profiler keeps only the device events it places inside its window.
# Closed as soon as the card has synchronised, it lost the last tiles of 1
# of 80 profiles of 5 replayed niw2mix sweeps on an H100; opened and closed
# this long away from the profiled work, card idle, 0 of 80 lost any
# (chip_profile_window.py).  The card's timestamps can also run fast against
# the host's clock, so the window's end drifts into the work it closes: on
# an H100 a step of 400 K1 launches, 2.14 s on the host's clock, read as
# 2.20 s of device time, and its last 7 launches fell after a 0.1 s pad.
# The pad after the work therefore grows with the work.
PROFILE_PAD_SECONDS = 0.1
PROFILE_PAD_SHARE = 0.25


def profile_pad(wall_seconds):
    """Seconds to leave the card idle after `wall_seconds` of profiled
    work before the profiler's window closes."""
    return max(PROFILE_PAD_SECONDS, PROFILE_PAD_SHARE * wall_seconds)


def profile_sweep(sweep, kernel_names):
    """Device time of one fused sweep by kernel name (`kernel_device_ms`:
    the kernels whose names hold one of `kernel_names`; `kernel_calls`:
    how many of them ran, by name), and the device's share of the sweep's
    wall time.  Only the device's own events count: an operator's row
    repeats the time of the kernels it launched.  Kernels replayed from a
    CUDA graph are the device's events too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_SECONDS)
        t0 = time.time()
        sweep()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
        time.sleep(profile_pad(wall_ms / 1e3))
    return device_profile(prof, wall_ms, kernel_names)


def device_profile(prof, wall_ms, kernel_names):
    """profile_sweep's reading of a finished torch.profiler profile that
    spans `wall_ms` of the host clock."""
    from torch.autograd import DeviceType
    rows = []
    calls = {}
    stat_calls = {}
    # first device event's start to last one's end, on the card's clock: above
    # wall_ms, the card's timestamps ran fast against the host's
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type != DeviceType.CPU]
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        dev_us = getattr(e, 'self_device_time_total',
                         getattr(e, 'self_cuda_time_total', 0))
        if dev_us > 0:
            rows.append((dev_us, e.key))
            for names, seen in ((kernel_names, calls),
                                (STAT_KERNELS, stat_calls)):
                for name in names:
                    if name in e.key:
                        seen[name] = seen.get(name, 0) + e.count
    rows.sort(reverse=True)
    total_ms = sum(us for us, _ in rows) / 1e3
    if not rows:
        return {'device_ms': 'not measured', 'wall_ms': wall_ms}
    kernel_ms = sum(us for us, k in rows
                    if any(name in k for name in kernel_names)) / 1e3
    # the stat stage of K1 and K2 (csrc/fused_stats.cuh), wherever it ran
    stat_ms = sum(us for us, k in rows
                  if any(name in k for name in STAT_KERNELS)) / 1e3
    span_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    return {'wall_ms': wall_ms, 'device_ms': total_ms,
            'device_span_ms': span_ms,
            'kernel_device_ms': kernel_ms, 'kernel_calls': calls,
            'stat_stage_device_ms': stat_ms, 'stat_stage_calls': stat_calls,
            'device_busy_share': total_ms / wall_ms,
            'top': [[k[:60], us / 1e3] for us, k in rows[:8]]}


def last_step_profiler(port, steps, wrapper):
    """A run_gibbs logger (diagnostics.SweepLogger) that starts the
    profiler when step `steps - 1` is logged, so that the last of `steps`
    steps runs under it.  Its `stop()`, called after the run, ends the
    profile and returns device_profile's reading of that step (its
    'kernel_calls' count split_score_sample, K1 and K2 on the slot-split
    walk), with 'launches_counted': what `wrapper.launches` rose by in the
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    class Logger(port['diagnostics'].SweepLogger):
        def log(self, sweep, **fields):
            row = super().log(sweep, **fields)
            if len(self.rows) == steps - 1:
                torch.cuda.synchronize()
                t = time.time()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                time.sleep(PROFILE_PAD_SECONDS)
                self.launches = wrapper.launches
                self.t0 = time.time()
                self.start_seconds = self.t0 - t
            return row

        def stop(self):
            torch.cuda.synchronize()
            t = time.time()
            wall_ms = 1e3 * (t - self.t0)
            time.sleep(profile_pad(wall_ms / 1e3))
            self.prof.stop()
            out = device_profile(self.prof, wall_ms, ('split_score_sample',))
            out.pop('top', None)
            # what the profiler cost the script besides the profiled step
            return dict(out, launches_counted=wrapper.launches
                        - self.launches, profiler_seconds={
                            'start': self.start_seconds,
                            'stop_and_read': time.time() - t})
    return Logger()


def phase_main(port, X, labels):
    import torch
    fk, mx, gibbs = port['fk'], port['mx'], port['gibbs']
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    state, assignments, log, main = run_main(
        port, fk.fused_score_sample_stats, spec, py, shareds, (X,), labels,
        BLOCK)
    values = (torch.as_tensor(X, device=assignments.device),)
    checks, score = check_run(port, spec, py, shareds, values, state,
                              assignments, log)
    cells = float(ROWS) * SLOTS * FEATURES
    main.update(phase='main', features=FEATURES, score_data=score,
                cells_per_sec=cells / (main['ms_per_sweep'] / 1e3),
                checks=checks)
    emit(main)

    # run_sweeps_pallas_fused, and the plain sweep at the same size
    cache = gibbs.build_stat_cache(spec, shareds, values, BLOCK, assignments)
    n_fused = 5
    gen = torch.Generator().manual_seed(1)

    def fused():
        return gibbs.run_sweeps_pallas_fused(
            spec, py, shareds, state, values, assignments, BLOCK, 2048, gen,
            cache, n_fused, sampling='gumbel')
    # a key's first call runs eagerly and its second captures the graph
    # (cuda_ms's warm-up): the timed calls are replays
    fused()
    fused_ms = cuda_ms(fused, 3) / n_fused

    def plain():
        return gibbs.sweep_blocked(spec, py, shareds, state, values,
                                   assignments, BLOCK, generator=gen)
    plain()     # likewise: the timed plain sweeps are replays
    plain_ms = cuda_ms(plain, 3)

    # where a fused sweep's time goes, by the profiler's device times
    breakdown = profile_sweep(
        lambda: gibbs.sweep_blocked_pallas_fused(
            spec, py, shareds, state, values, assignments, BLOCK, 2048, gen,
            cache, sampling='gumbel'), ('split_score_sample', 'fused_v2'))
    emit({'phase': 'paths', 'run_sweeps_pallas_fused_ms_per_sweep': fused_ms,
          'plain_sweep_blocked_ms_per_sweep': plain_ms,
          'fused_cells_per_sec': cells / (fused_ms / 1e3),
          'plain_cells_per_sec': cells / (plain_ms / 1e3),
          'fused_sweep_profile': breakdown})
    return main['launches']


def phase_main_mixed(port, problem):
    """`problem`: testing.mixed_problem(ROWS, SLOTS, kind='niw2mix')."""
    import torch
    fk, mx, gibbs, testing = (port['fk'], port['mx'], port['gibbs'],
                              port['testing'])
    spec, py, shareds = testing.build_problem(
        problem, port['models'], mx.make_spec, port['cl'].PitmanYor.from_dict)
    state, assignments, log, main = run_main(
        port, fk.fused_mixed_score_sample_stats, spec, py, shareds,
        problem['values'], problem['labels'], BLOCK_MIXED)
    values = tuple(torch.as_tensor(v, device=assignments.device)
                   for v in problem['values'])
    checks, score = check_run(port, spec, py, shareds, values, state,
                              assignments, log)
    feat_cells = float(ROWS) * SLOTS * len(spec.blocks)
    main.update(phase='main_mixed', layout='niw2mix', score_data=score,
                cells_per_sec=feat_cells / (main['ms_per_sweep'] / 1e3),
                checks=checks)
    emit(main)

    cache = gibbs.build_stat_cache(spec, shareds, values, BLOCK_MIXED,
                                   assignments)
    gen = torch.Generator().manual_seed(1)

    def fused():
        return gibbs.sweep_blocked_pallas_fused_mixed(
            spec, py, shareds, state, values, assignments, BLOCK_MIXED, 2048,
            gen, cache, sampling='gumbel')
    fused()     # the key's first call: eager; cuda_ms's warm-up captures
    fused_ms = cuda_ms(fused, 3)

    def plain():
        return gibbs.sweep_blocked(spec, py, shareds, state, values,
                                   assignments, BLOCK_MIXED, generator=gen)
    plain()     # likewise: the timed plain sweeps are replays
    plain_ms = cuda_ms(plain, 2)
    emit({'phase': 'paths_mixed',
          'fused_mixed_ms_per_sweep': fused_ms,
          'plain_sweep_blocked_ms_per_sweep': plain_ms,
          'per_tile_host_ms': tile_bookkeeping_ms(port, spec, py, shareds,
                                                  state, values, cache),
          'fused_sweep_profile': profile_sweep(
              fused, ('split_score_sample', 'fused_v3'))})
    return main['launches']


# -- the runner's sweeps as CUDA graphs --------------------------------------

GRAPH_SWEEPS = 10
GRAPH_MODES = ('gumbel', 'argmax', 'cdf')
GROW_ROWS = 65536
GROW_BLOCK = 16384
GROW_CAPACITY = 32
GRAPH_LE_SWEEPS = (2, 3)        # steps, sweeps a step
GRAPH_TIMED_STEPS = (2, 10)
GRAPH_PROFILED = 5              # replayed sweeps in one profiled call


def bits_equal(a, b):
    """Every tensor of two results (tensors in nested tuples) equal bit for
    bit, in the same nesting (compared as bytes: a NaN equals itself, -0
    differs from 0)."""
    import torch
    from distributions_tpu_torch.ops.gibbs import _tensors
    ta, tb = list(_tensors(a)), list(_tensors(b))
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(ta, tb))


def graph_problems(port, X, labels, mixed):
    """nich2 and niw2mix at full width, values and labels on the card:
    (spec, prior, shareds, values, labels, block, K wrapper, kernel name)."""
    import torch
    mx, testing, nich = port['mx'], port['testing'], port['nich']
    fk = port['fk']
    dev = port['config'].default_device()
    py = port['cl'].PitmanYor.from_dict(PY)
    spec2, _, sh2 = testing.build_problem(
        mixed, port['models'], mx.make_spec, port['cl'].PitmanYor.from_dict)
    return {
        'nich2': (mx.make_spec([(nich, FEATURES)], capacity=SLOTS), py,
                  (nich.shared_from_dict(SHARED),),
                  (torch.as_tensor(X, device=dev),),
                  torch.as_tensor(labels, device=dev), BLOCK,
                  fk.fused_score_sample_stats, 'fused_v2'),
        'niw2mix': (spec2, py, sh2,
                    tuple(torch.as_tensor(v, device=dev)
                          for v in mixed['values']),
                    torch.as_tensor(mixed['labels'], device=dev),
                    BLOCK_MIXED, fk.fused_mixed_score_sample_stats,
                    'fused_v3')}


def run_graph_and_eager(port, fn):
    """fn() on the graph path, then under gibbs._eager_sweeps(): (graph
    result, eager result, graph counters of the first, wall ms of each)."""
    gibbs = port['gibbs']
    stats = graph_counts(port)
    g, g_ms = timed(fn)
    counts = dict(stats)
    with gibbs._eager_sweeps():
        e, e_ms = timed(fn)
    return g, e, counts, g_ms, e_ms


def runs_equal(what, a, b, log_a=None, log_b=None):
    """Two (state, assignments, ...) results bitwise equal, and their
    logger rows alike but for the clock (`diagnostics.CLOCK_KEYS`)."""
    from distributions_tpu_torch import diagnostics
    ok = bits_equal(a, b)
    if log_a is not None:
        def rows(log):
            return [{k: v for k, v in r.items()
                     if k not in diagnostics.CLOCK_KEYS} for r in log.rows]
        ok = ok and rows(log_a) == rows(log_b)
    if not ok:
        raise AssertionError('%s: the graph path and the eager loop differ'
                             % what)
    return True


def phase_graphs(port, X, labels, mixed):
    """Each sweep of run_gibbs(use_pallas=True) as the replay of one CUDA
    graph (gibbs._SweepGraph) against the eager loop with the seeds passed
    by value (gibbs._eager_sweeps), bitwise, at 1,048,576 rows x 1024
    slots: nich2 (K1, 8 tiles) and niw2mix (K2, 16 tiles)."""
    import numpy as np
    import torch
    mx, gibbs, rnd, runner = (port['mx'], port['gibbs'], port['random'],
                              port['runner'])
    out = {'phase': 'graphs', 'rows': ROWS, 'slots': SLOTS, 'seconds': {}}
    t0 = time.time()

    def lap(name):
        out['seconds'][name] = round(time.time() - t0 - sum(
            out['seconds'].values()), 2)
    problems = graph_problems(port, X, labels, mixed)
    for layout, (spec, py, shareds, values, an, block, kernel,
                 kname) in problems.items():
        tiles = ROWS // block
        state = mx.state_from_assignments(spec, py, shareds, values, an)
        cache = gibbs.build_stat_cache(spec, shareds, values, block, an)
        res = {'tiles': tiles, 'block': block}

        def call(st, a, c, gen, mode='gumbel', n=1, score=False):
            return gibbs.sweep_blocked_pallas_fused_mixed(
                spec, py, shareds, st, values, a, block, 2048, gen, c,
                sampling=mode, n_sweeps=n, with_score=score)

        def capture(mode='gumbel'):
            # a key's first call runs eagerly, its second captures the
            # graph, and the calls after it replay
            for seed in (20, 21):
                call(state, an, cache, torch.Generator().manual_seed(seed),
                     mode)

        # graph against eager, bitwise: 10 sweeps from one seed per mode
        for mode in GRAPH_MODES:
            # the key's first call (eager): the run below captures
            call(state, an, cache, torch.Generator().manual_seed(20), mode)
            kernel.launches = 0
            g, e, counts, g_ms, e_ms = run_graph_and_eager(
                port, lambda: call(state, an, cache,
                                   torch.Generator().manual_seed(7), mode,
                                   GRAPH_SWEEPS, True))
            want = {'captures': 1, 'replays': GRAPH_SWEEPS - 1,
                    'score_captures': 1, 'score_replays': 0}
            if {k: counts[k] for k in want} != want:
                raise AssertionError('graphs %s %s: counters %s, expected '
                                     '%s' % (layout, mode, counts, want))
            if kernel.launches != 2 * tiles * GRAPH_SWEEPS:
                raise AssertionError('graphs %s %s: %d launches, expected '
                                     'tiles x sweeps x 2 runs = %d'
                                     % (layout, mode, kernel.launches,
                                        2 * tiles * GRAPH_SWEEPS))
            res[mode] = {
                'equal': {
                    'assignments': bits_equal(g[1], e[1]),
                    'counts': bits_equal(g[0].counts, e[0].counts),
                    'stat_sums': bits_equal(g[0].groups, e[0].groups),
                    'state': bits_equal(g[0], e[0]),
                    'cache': bits_equal(g[2], e[2]),
                    'score': bits_equal(g[3], e[3])},
                'graph_ms': g_ms, 'eager_ms': e_ms,
                'capture_seconds': counts['capture_seconds'],
                'pool_bytes': counts['pool_bytes']}
            if not all(res[mode]['equal'].values()):
                raise AssertionError('graphs %s %s: graph and eager differ: '
                                     '%s' % (layout, mode, res[mode]))

        # fresh seeds every replay: two single-sweep calls from one state
        # and one generator replay one graph with other seeds and other
        # draws, each equal to the eager sweep from the same generator
        gen, gen_e = (torch.Generator().manual_seed(11),
                      torch.Generator().manual_seed(11))
        capture()
        stats = graph_counts(port)
        g1 = call(state, an, cache, gen)
        graph = gibbs._GRAPH['graph']
        seeds1 = graph.seeds.to('cpu', copy=True)
        g2 = call(state, an, cache, gen)
        seeds2 = graph.seeds.to('cpu', copy=True)
        with gibbs._eager_sweeps():
            e1 = call(state, an, cache, gen_e)
            e2 = call(state, an, cache, gen_e)
        want_seeds = rnd.sweep_seeds(torch.Generator().manual_seed(11),
                                     tiles)
        fresh = {
            'replays': stats['replays'] == 2 and stats['captures'] == 0,
            'seeds_differ': bool((seeds1 != seeds2).all()),
            'seeds_are_the_generators': bool(torch.equal(seeds1,
                                                         want_seeds)),
            'draws_differ': not bool(torch.equal(g1[1], g2[1])),
            'first_equals_eager': bits_equal(g1, e1),
            'second_equals_eager': bits_equal(g2, e2)}
        res['fresh_seeds'] = dict(
            fresh, rows_moved_between_replays=int((g1[1] != g2[1]).sum()))
        if not all(fresh.values()):
            raise AssertionError('graphs %s: fresh seeds: %s'
                                 % (layout, res['fresh_seeds']))

        # no aliasing: what step s returned is untouched by step s + 1
        s1 = call(state, an, cache, gen)
        kept = gibbs._map_tensors(torch.clone, s1)
        s2 = call(*s1, gen)
        statics = {t.data_ptr() for t in gibbs._tensors(graph.static)}
        ptrs1 = {t.data_ptr() for t in gibbs._tensors(s1)}
        alias = {
            'unchanged': bits_equal(s1, kept),
            'not_the_next_result': not ptrs1 & {t.data_ptr()
                                                for t in gibbs._tensors(s2)},
            'not_the_graph_buffers': not ptrs1 & statics}
        res['no_aliasing'] = alias
        if not all(alias.values()):
            raise AssertionError('graphs %s: aliasing: %s' % (layout, alias))

        # the profiler sees the kernels inside the replayed sweeps of one
        # call: K1 or K2 once a tile; device ms and busy share a sweep of a
        # 5-sweep call on the graph, of one sweep eagerly
        gen = torch.Generator().manual_seed(3)
        n = GRAPH_PROFILED
        prof = profile_sweep(
            lambda: call(state, an, cache, gen, n=n),
            ('split_score_sample', kname))
        res['profile_graph'] = dict(prof, sweeps=n)
        for k in ('wall_ms', 'device_ms', 'kernel_device_ms'):
            if isinstance(prof.get(k), float):
                res['profile_graph'][k + '_per_sweep'] = prof[k] / n
        with gibbs._eager_sweeps():
            res['profile_eager'] = profile_sweep(
                lambda: call(state, an, cache, gen), ('split_score_sample',
                                                      kname))
        calls = prof.get('kernel_calls', {})
        if calls.get('split_score_sample') != n * tiles:
            raise AssertionError('graphs %s: the profile of %d replays '
                                 'shows %s score + sample launches, '
                                 'expected %d (profile: %s)'
                                 % (layout, n, calls, n * tiles, prof))

        # a call made once (values new to the graph path, here a fresh
        # copy for each call) runs eagerly and captures nothing: its time
        # against the eager loop's, in turns
        stats = graph_counts(port)
        one = {'graph_path': [], 'eager': []}
        for kind in ('graph_path', 'eager', 'eager', 'graph_path'):
            fresh = tuple(v.clone() for v in values)

            def once():
                return gibbs.sweep_blocked_pallas_fused_mixed(
                    spec, py, shareds, state, fresh, an, block, 2048,
                    torch.Generator().manual_seed(9), cache,
                    sampling='gumbel')
            if kind == 'eager':
                with gibbs._eager_sweeps():
                    one[kind].append(timed(once)[1])
            else:
                one[kind].append(timed(once)[1])
        res['one_shot_ms'] = dict(one, first_uses=stats['first_uses'],
                                  captures=stats['captures'])
        if stats['captures'] or stats['first_uses'] != 2:
            raise AssertionError('graphs %s: a call made once captured a '
                                 'graph: %s' % (layout, res['one_shot_ms']))
        out[layout] = res
        del state, cache
        lap(layout)

    # capacity growth mid-run recaptures, and equals the eager run
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=GROW_CAPACITY)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)

    def grow_run():
        return runner.run_gibbs(
            spec, py, shareds, (X[:GROW_ROWS],),
            torch.Generator().manual_seed(2), 6, block=GROW_BLOCK,
            use_pallas=True, sampling='gumbel', grow_headroom=0.5,
            sweeps_per_step=2, initial_assignments=labels[:GROW_ROWS] % 16)
    g, e, counts, g_ms, e_ms = run_graph_and_eager(port, grow_run)
    capacity = int(g[0].counts.shape[0])
    grown = int(np.log2(capacity // GROW_CAPACITY))
    out['growth'] = {'final_capacity': capacity, 'captures':
                     counts['captures'], 'replays': counts['replays'],
                     'equal': runs_equal('growth', g[:2], e[:2], g[2], e[2])}
    if not (grown >= 1 and counts['captures'] == 1 + grown
            and counts['replays'] == 6 - counts['captures']):
        raise AssertionError('graphs: growth %s' % out['growth'])
    lap('growth')

    # the hyper moves of main_hypers: new shareds and prior copied into the
    # graph's buffers
    out['hypers'] = graph_hypers(port, X, labels)
    lap('hypers')

    # LowEntropy, both layouts
    le = port['cl'].LowEntropy.from_dict(LE)
    steps, per_step = GRAPH_LE_SWEEPS
    out['low_entropy'] = {}
    for layout, (spec, _, shareds, values, an, block, _,
                 _) in problems.items():
        g, e, counts, g_ms, e_ms = run_graph_and_eager(
            port, lambda: runner.run_gibbs(
                spec, le, shareds, values, torch.Generator().manual_seed(4),
                steps * per_step, block=block, use_pallas=True,
                sampling='gumbel', initial_assignments=an, grow_headroom=0.0,
                sweeps_per_step=per_step))
        expect_graph('graphs LowEntropy ' + layout, counts,
                     steps * per_step, steps)
        out['low_entropy'][layout] = {
            'equal': runs_equal('LowEntropy ' + layout, g[:2], e[:2], g[2],
                                e[2]),
            'graph_wall_ms': g_ms, 'eager_wall_ms': e_ms}
    lap('low_entropy')

    # ms/sweep of run_gibbs, graph and eager in turns (graph, eager, eager,
    # graph), steady steps only
    steps, per_step = GRAPH_TIMED_STEPS
    out['timing'] = {}
    for layout, (spec, py, shareds, values, an, block, _,
                 _) in problems.items():
        by = {'graph': [], 'eager': []}
        capture = []
        for kind in ('graph', 'eager', 'eager', 'graph'):
            # each graph run captures its graph in its first step, and
            # frees it at its end
            stats = graph_counts(port)

            def run():
                return runner.run_gibbs(
                    spec, py, shareds, values,
                    torch.Generator().manual_seed(0), steps * per_step,
                    block=block, use_pallas=True, sampling='gumbel',
                    initial_assignments=an, grow_headroom=0.0,
                    sweeps_per_step=per_step)
            if kind == 'eager':
                with gibbs._eager_sweeps():
                    _, _, log = run()
            else:
                _, _, log = run()
                capture.append({'capture_seconds': stats['capture_seconds'],
                                'pool_bytes': stats['pool_bytes']})
            by[kind].append(1e3 * sum(r['seconds'] for r in log.rows[1:])
                            / (per_step * (steps - 1)))
        graph_prof = out[layout]['profile_graph']
        eager_prof = out[layout]['profile_eager']
        out['timing'][layout] = {
            'ms_per_sweep_graph': by['graph'],
            'ms_per_sweep_eager': by['eager'], 'graph_capture': capture,
            'device_ms_per_sweep_graph': graph_prof.get(
                'device_ms_per_sweep'),
            'busy_share_graph': graph_prof.get('device_busy_share'),
            'device_ms_per_sweep_eager': eager_prof.get('device_ms'),
            'busy_share_eager': eager_prof.get('device_busy_share')}
    lap('timing')
    emit(out)


def graph_hypers(port, X, labels):
    """phase_main_hypers' run (nich2, a 64-point sigmasq grid and an 8 x 8
    Pitman-Yor grid every 5 of 10 sweeps) on the graph path and on the
    eager loop: bitwise equal, with one capture for the whole run."""
    import numpy as np
    import torch
    mx, hypers, nich = port['mx'], port['hypers'], port['nich']
    dev = port['config'].default_device()
    spec = mx.make_spec([(nich, FEATURES)], capacity=SLOTS)
    G = 64
    grid = nich.Shared(
        mu=torch.zeros(G, device=dev),
        kappa=torch.full((G,), SHARED['kappa'], device=dev),
        sigmasq=torch.as_tensor(np.logspace(-4, 0, G).astype(np.float32),
                                device=dev),
        nu=torch.ones(G, device=dev))
    cl_grid = hypers.make_py_grid(np.logspace(-1, 2, 8).astype(np.float32),
                                  np.linspace(0.0, 0.7, 8).astype(np.float32))
    passes, every = 10, 5
    g, e, counts, g_ms, e_ms = run_graph_and_eager(
        port, lambda: port['runner'].run_gibbs(
            spec, port['cl'].PitmanYor.from_dict(PY),
            (nich.shared_from_dict(SHARED),), (X,),
            torch.Generator().manual_seed(0), passes, block=BLOCK,
            use_pallas=True, sampling='gumbel', initial_assignments=labels,
            grow_headroom=0.0, sweeps_per_step=every,
            hyper_grids={0: grid}, cl_grid=cl_grid, hyper_every=every))
    expect_graph('graphs hypers', counts, passes, passes // every)
    moves = [(r.get('hyper_0'), r.get('hyper_cl')) for r in g[2].rows]
    return {'equal': runs_equal('hypers', g[:2], e[:2], g[2], e[2]),
            'final_shareds_equal': bits_equal(g[2].final_shareds,
                                              e[2].final_shareds),
            'moves': moves, 'graph_wall_ms': g_ms, 'eager_wall_ms': e_ms}


def check_sweep(port, spec, py, shareds, values, state, assignments):
    """A sweep's outputs are consistent: counts equal a bincount of the
    assignments, and the state's score_data equals that of a state built
    afresh from them."""
    import torch
    mx = port['mx']
    counts_ok = bool(torch.equal(
        torch.bincount(assignments.long(), minlength=spec.capacity).to(
            torch.int32), state.counts))
    score = float(mx.score_data(spec, py, shareds, state))
    fresh = float(mx.score_data(spec, py, shareds, mx.state_from_assignments(
        spec, py, shareds, values, assignments)))
    if not (counts_ok and abs(score - fresh) <= 1e-4 * abs(fresh)):
        raise AssertionError('sweep output is inconsistent: counts ok %s, '
                             'score %r, fresh %r' % (counts_ok, score, fresh))
    return {'counts_equal_bincount': counts_ok, 'score_data': score,
            'fresh_score_data': fresh}


V1_SWEEPS = 10
V1_MODES = ('gumbel', 'argmax')
V1_TIMED = 5


def graph_sweep_checks(port, what, one, tiles, wrapper, modes, gens=False,
                       sweeps=V1_SWEEPS, timed_sweeps=V1_TIMED):
    """The checks of a one-sweep entry point on the graph path.  one(st,
    an, mode, gen) runs one sweep, from the start's (state, assignments)
    when st is None.  Per mode, `sweeps` chained sweeps replayed from one
    CUDA graph (after the key's first call, eager) against the eager
    loop, bitwise, with tiles x sweeps launches of `wrapper` (None: a
    sweep without a kernel); in the first mode also fresh seeds every
    replay (`gens`: from the graph's device generator), the profile of
    one replayed sweep (one score + sample kernel a tile) and ms/sweep on
    the graph and eagerly in turns.  Returns (report, launches of the
    first mode's graph run, its result)."""
    import torch

    def chain(mode, n):
        gen = torch.Generator().manual_seed(7)
        st = an = None
        for _ in range(n):
            st, an = one(st, an, mode, gen)
        return st, an
    res = {}
    # the first mode last: its graph is the one kept for what follows
    for mode in modes[::-1]:
        one(None, None, mode, torch.Generator().manual_seed(7))
        g, res[mode] = sharded_graph_check(
            port, '%s %s' % (what, mode), lambda: chain(mode, sweeps),
            wrapper, tiles * sweeps if wrapper else 0, sweeps, 0)
    launches = res[mode]['launches_graph_run']
    res['fresh_seeds'] = sharded_fresh_seeds(
        port, what, lambda gen: one(None, None, mode, gen), tiles, gens)
    if wrapper is not None:
        res['profile_replay'] = sharded_profile(
            port, what, lambda: one(None, None, mode,
                                    torch.Generator().manual_seed(7)),
            tiles)
    res['timing'] = graph_eager_turns(
        port, lambda: chain(mode, timed_sweeps), timed_sweeps)
    return res, launches, g


def phase_paths_v1(port, X, labels):
    """The v1 sweeps at full width, each sweep the replay of one CUDA graph
    of all its tiles (K4 and K5 reading their seed from the seed table,
    'xla' drawing from the graph's device generator): K4 on nich2 and K5
    on nichbbddgp in 'gumbel' and 'argmax', and backend='xla', against the
    eager loop.  Returns the launches of K4 and K5 in their 'gumbel' graph
    runs."""
    import torch
    fk, mx, gibbs, testing = (port['fk'], port['mx'], port['gibbs'],
                              port['testing'])
    dev = port['config'].default_device()
    out = {'phase': 'paths_v1', 'rows': ROWS, 'slots': SLOTS,
           'sweeps_checked': V1_SWEEPS, 'seconds': {}}
    t0 = time.time()

    # nich2 through sweep_blocked_pallas (K4)
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    values = (torch.as_tensor(X, device=dev),)
    a0 = torch.as_tensor(labels, device=dev)
    st0 = mx.state_from_assignments(spec, py, shareds, values, a0)
    tiles = ROWS // BLOCK

    def k4(st, an, mode, gen):
        return gibbs.sweep_blocked_pallas(
            spec, py, shareds, st0 if st is None else st, values,
            a0 if an is None else an, BLOCK, generator=gen, sampling=mode)
    res, k4_launches, g = graph_sweep_checks(
        port, 'sweep_blocked_pallas nich2', k4, tiles, fk.nich_score_sample,
        V1_MODES)
    st2, an2 = k4(*k4(None, None, 'gumbel',
                      torch.Generator().manual_seed(2)), 'gumbel',
                  torch.Generator().manual_seed(3))
    out['nich2'] = dict(res, block=BLOCK, tiles=tiles,
                        checks=check_sweep(port, spec, py, shareds, values,
                                           st2, an2))
    del values, st0, g, st2, an2
    out['seconds']['nich2'] = round(time.time() - t0, 2)

    # nich + bb + dd + gp through sweep_blocked_pallas_mixed (K5, 'xla')
    problem = testing.mixed_problem(ROWS, SLOTS, seed=0, kind='nichbbddgp',
                                    n_clusters=TRUE_CLUSTERS)
    spec, py, shareds = testing.build_problem(
        problem, port['models'], mx.make_spec, port['cl'].PitmanYor.from_dict)
    values = tuple(torch.as_tensor(v, device=dev) for v in problem['values'])
    a0 = torch.as_tensor(problem['labels'], device=dev)
    st0 = mx.state_from_assignments(spec, py, shareds, values, a0)
    supports = gibbs._block_supports(spec, values)
    tiles = ROWS // BLOCK_MIXED
    mixed = {'block': BLOCK_MIXED, 'tiles': tiles}

    def mixed_sweep(backend):
        def one(st, an, mode, gen):
            return gibbs.sweep_blocked_pallas_mixed(
                spec, py, shareds, st0 if st is None else st, values,
                a0 if an is None else an, BLOCK_MIXED, gen,
                supports=supports, backend=backend, sampling=mode)
        return one
    mixed['pallas'], k5_launches, g = graph_sweep_checks(
        port, 'sweep_blocked_pallas_mixed nichbbddgp', mixed_sweep('pallas'),
        tiles, fk.mixed_score_sample, V1_MODES)
    mixed['pallas']['checks'] = check_sweep(port, spec, py, shareds, values,
                                            *g)
    mixed['xla'], _, g = graph_sweep_checks(
        port, "sweep_blocked_pallas_mixed(backend='xla') nichbbddgp",
        mixed_sweep('xla'), tiles, None, ('gumbel',), gens=True)
    mixed['xla']['checks'] = check_sweep(port, spec, py, shareds, values,
                                         *g)
    del g
    out['seconds']['nichbbddgp_v1'] = round(
        time.time() - t0 - sum(out['seconds'].values()), 2)

    # the same problem on the fused path (K2) and the plain path
    cache = gibbs.build_stat_cache(spec, shareds, values, BLOCK_MIXED, a0)
    gen = torch.Generator().manual_seed(2)

    def fused():
        return gibbs.sweep_blocked_pallas_fused_mixed(
            spec, py, shareds, st0, values, a0, BLOCK_MIXED, 2048, gen, cache,
            sampling='gumbel', supports=supports)
    fused()     # the key's first call: eager; cuda_ms's warm-up captures
    mixed['fused_mixed_ms_per_sweep'] = cuda_ms(fused, 2)

    def plain():
        return gibbs.sweep_blocked(spec, py, shareds, st0, values, a0,
                                   BLOCK_MIXED, generator=gen)
    plain()     # likewise: the timed plain sweeps are replays
    mixed['plain_sweep_blocked_ms_per_sweep'] = cuda_ms(plain, 2)
    out['nichbbddgp'] = mixed
    emit(out)
    return k4_launches, k5_launches


PLAIN_SWEEPS = 3
PLAIN_CASES = (('nich2', 4096), ('nich2', BLOCK), ('niw2mix', BLOCK_MIXED))
PLAIN_RUN = (3, 3)          # steps, sweeps a step of run_gibbs
PLAIN_RUN_BLOCK = 4096      # run_gibbs's default block
PLAIN_RUN_SLOTS = 4 * SLOTS
CHAIN_GRAPH_SWEEPS = 3


def phase_plain_graphs(port, X, labels, mixed):
    """The single-device plain sweeps, each sweep the replay of one CUDA
    graph of all its tiles drawing from the graph's device generator
    (reseeded from the host before each replay), against the eager loop:
    sweep_blocked at 1,048,576 rows x 1024 slots on nich2 (tiles of 4096,
    the runner's default, and 131,072) and niw2mix (65,536), 3 sweeps
    bitwise, fresh seeds, ms/sweep in turns; run_gibbs(use_pallas=False)
    on nich2 at its default tiles (4096 slots), 3 steps of 3 sweeps, every
    sweep but the first a replay, bitwise its eager run, resume bitwise;
    sweep_blocked_chains, 4 chains of 65,536 rows in one replay a sweep,
    bitwise the eager chains."""
    import shutil
    import tempfile
    import torch
    mx, gibbs, runner = port['mx'], port['gibbs'], port['runner']
    out = {'phase': 'plain_graphs', 'rows': ROWS, 'slots': SLOTS,
           'sweeps_checked': PLAIN_SWEEPS, 'seconds': {}}
    t0 = time.time()
    problems = graph_problems(port, X, labels, mixed)
    for layout, block in PLAIN_CASES:
        spec, py, shareds, values, a0, _, _, _ = problems[layout]
        st0 = mx.state_from_assignments(spec, py, shareds, values, a0)

        def one(st, an, mode, gen):
            return gibbs.sweep_blocked(
                spec, py, shareds, st0 if st is None else st, values,
                a0 if an is None else an, block, generator=gen)
        res, _, g = graph_sweep_checks(
            port, 'sweep_blocked %s block %d' % (layout, block), one,
            ROWS // block, None, ('gumbel',), gens=True, sweeps=PLAIN_SWEEPS,
            timed_sweeps=PLAIN_SWEEPS)
        res.update(block=block, tiles=ROWS // block,
                   checks=check_sweep(port, spec, py, shareds, values, *g))
        out['sweep_blocked_%s_%d' % (layout, block)] = res
        del st0, g
        gibbs.release_sweep_graphs()
    out['seconds']['sweep_blocked'] = round(time.time() - t0, 2)

    # the runner's default path: run_gibbs(use_pallas=False), block 4096.
    # A tile opens at most one cluster (one reserved empty slot), so 256
    # tiles open up to 256 a sweep, where the 131,072-row tiles open 8:
    # from the 896 generating clusters 1024 slots fill within 3 sweeps,
    # and PLAIN_RUN_SLOTS hold 896 + 9 x 256 with no growth
    spec, py, shareds = problems['nich2'][:3]
    spec = spec._replace(capacity=PLAIN_RUN_SLOTS)
    steps, per_step = PLAIN_RUN
    passes = steps * per_step
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        def run(n, path=None, seed=0, resume=False):
            return runner.run_gibbs(
                spec, py, shareds, (X,), torch.Generator().manual_seed(seed),
                n, block=PLAIN_RUN_BLOCK, use_pallas=False,
                initial_assignments=labels, grow_headroom=0.0,
                sweeps_per_step=per_step, checkpoint_every=per_step,
                checkpoint_path=path and os.path.join(tmp, path),
                resume=resume)
        stats = graph_counts(port)
        g, g_ms = timed(lambda: run(passes, 'full.ckpt'))
        graphs = expect_graph('run_gibbs(use_pallas=False)', stats, passes,
                              steps)
        with gibbs._eager_sweeps():
            e, e_ms = timed(lambda: run(passes))
        run(passes - per_step, 'crash.ckpt')
        r = run(passes, 'crash.ckpt', seed=999, resume=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs_equal('run_gibbs(use_pallas=False)', g[:2], e[:2], g[2], e[2])
    runs_equal('run_gibbs(use_pallas=False) resumed', g[:2], r[:2], g[2],
               r[2])
    steady = [row['seconds'] for row in g[2].rows][1:]
    out['run_gibbs_plain'] = {
        'block': PLAIN_RUN_BLOCK, 'steps': steps, 'sweeps_per_step':
        per_step, 'slots': PLAIN_RUN_SLOTS,
        'nonempty_groups': [row['nonempty_groups'] for row in g[2].rows],
        'graphs': graphs, 'equal_eager': True,
        'resume_bitwise': True, 'graph_wall_ms': g_ms, 'eager_wall_ms': e_ms,
        'step_seconds': [row['seconds'] for row in g[2].rows],
        'step_seconds_eager': [row['seconds'] for row in e[2].rows],
        'ms_per_sweep_steady': 1e3 * sum(steady) / (per_step * len(steady))}
    del g, e, r
    out['seconds']['run_gibbs_plain'] = round(
        time.time() - t0 - sum(out['seconds'].values()), 2)

    # 4 chains in one replay a sweep
    spec, py, shareds, values, a0, _, _, _ = problems['nich2']
    cv = (values[0][:CHAIN_ROWS].contiguous(),)
    gen = torch.Generator().manual_seed(0)
    A = torch.stack([a0[:CHAIN_ROWS]] + [
        torch.randint(0, SLOTS // 2, (CHAIN_ROWS,), generator=gen).to(
            device=a0.device, dtype=torch.int32) for _ in range(CHAINS - 1)])
    states = gibbs.init_chains(spec, py, shareds, cv, A)

    def chains(n):
        gens = [torch.Generator().manual_seed(10 + c) for c in range(CHAINS)]
        sts, an = states, A
        for _ in range(n):
            sts, an = gibbs.sweep_blocked_chains(spec, py, shareds, sts, cv,
                                                 an, CHAIN_BLOCK, gens)
        return sts, an
    chains(1)       # the key's first call runs eagerly
    g, res = sharded_graph_check(port, 'sweep_blocked_chains',
                                 lambda: chains(CHAIN_GRAPH_SWEEPS), None, 0,
                                 CHAIN_GRAPH_SWEEPS, 0)
    for c in range(CHAINS):
        check_sweep(port, spec, py, shareds, cv, gibbs._chain_take(g[0], c),
                    g[1][c])
    res.update(chains=CHAINS, rows=CHAIN_ROWS, block=CHAIN_BLOCK,
               timing=graph_eager_turns(
                   port, lambda: chains(CHAIN_GRAPH_SWEEPS),
                   CHAIN_GRAPH_SWEEPS))
    out['sweep_blocked_chains'] = res
    gibbs.release_sweep_graphs()
    out['seconds']['chains'] = round(
        time.time() - t0 - sum(out['seconds'].values()), 2)
    emit(out)


def phase_main_resume(port, X, labels):
    """Interrupted plus resumed against uninterrupted, through run_gibbs
    with checkpoint_path: the fused path at full width, the plain path at
    a quarter of the rows."""
    import shutil
    import tempfile
    import torch
    runner, mx, ckpt = port['runner'], port['mx'], port['checkpoint']
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    out = {'phase': 'main_resume'}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        for name, use_pallas, rows, block in (
                ('fused', True, ROWS, BLOCK),
                ('plain', False, ROWS // 4, BLOCK_MIXED)):
            common = dict(block=block, use_pallas=use_pallas,
                          sampling='gumbel', grow_headroom=0.0,
                          checkpoint_every=2, sweeps_per_step=2,
                          initial_assignments=labels[:rows])
            vals = (X[:rows],)

            def run(passes, path, seed, resume):
                return runner.run_gibbs(
                    spec, py, shareds, vals, torch.Generator().manual_seed(seed),
                    passes, checkpoint_path=os.path.join(tmp, path),
                    resume=resume, **common)
            st_a, an_a, log_a = run(4, name + '_full.ckpt', 5, False)
            run(2, name + '_crash.ckpt', 5, False)
            st_b, an_b, log_b = run(4, name + '_crash.ckpt', 999, True)
            checks = {
                'assignments_equal': bool(torch.equal(an_a, an_b)),
                'counts_equal': bool(torch.equal(st_a.counts, st_b.counts)),
                'stats_equal': all(
                    bool(torch.equal(x, y))
                    for x, y in zip(st_a.groups[0], st_b.groups[0])),
                'sweeps_continuous':
                    [r['sweep'] for r in log_b.rows] == [1, 3]
                    == [r['sweep'] for r in log_a.rows],
                'score_equal': log_a.rows[-1]['score_data']
                    == log_b.rows[-1]['score_data'],
                'on_the_card': an_b.device.type == 'cuda',
            }
            if not all(checks.values()):
                raise AssertionError('%s path: resume is not bitwise: %s'
                                     % (name, checks))
            out[name] = dict(checks, rows=rows, block=block)
            if name == 'fused':
                path = os.path.join(tmp, 'timed.ckpt')
                gen = torch.Generator().manual_seed(1)
                torch.cuda.synchronize()
                t0 = time.time()
                ckpt.save(path, st_a, assignments=an_a, generator=gen,
                          sweep=4, logger_rows=log_a.rows, shareds=shareds,
                          cl_model=py, spec=spec)
                t1 = time.time()
                loaded = ckpt.load_extended(path, spec, shareds)
                torch.cuda.synchronize()
                t2 = time.time()
                if not torch.equal(loaded[1], an_a):
                    raise AssertionError('checkpoint does not load back')
                out['checkpoint'] = {'rows': rows, 'save_seconds': t1 - t0,
                                     'load_seconds': t2 - t1,
                                     'file_bytes': os.path.getsize(path)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)


def phase_init(port, X):
    """run_gibbs with its default init ('prior') at full width, and with
    init='sequential' on a few hundred rows; ms per row of both."""
    import torch
    runner, mx, gibbs = port['runner'], port['mx'], port['gibbs']
    dev = port['config'].default_device()
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    out = {'phase': 'init'}

    t0 = time.time()
    state, an, log = runner.run_gibbs(
        spec, py, shareds, (X,), torch.Generator().manual_seed(0), 1,
        block=BLOCK, use_pallas=True, sampling='gumbel')
    torch.cuda.synchronize()
    wall = time.time() - t0
    values = (torch.as_tensor(X, device=dev),)
    check_sweep(port, spec._replace(capacity=state.counts.shape[0]), py,
                shareds, values, state, an)
    torch.cuda.synchronize()
    t0 = time.time()
    st_p, an_p = gibbs.prior_init(spec, py, shareds, mx.init(spec, shareds),
                                  values, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    out['prior'] = {
        'rows': ROWS, 'run_gibbs_one_sweep_wall_seconds': wall,
        'prior_init_seconds': seconds, 'ms_per_row': 1e3 * seconds / ROWS,
        'groups_after_init': int((st_p.counts > 0).sum()),
        'groups_after_one_sweep': log.rows[-1]['nonempty_groups'],
        'on_the_card': an.device.type == 'cuda'}
    check_sweep(port, spec, py, shareds, values, st_p, an_p)

    n = 512
    small = (values[0][:n].contiguous(),)
    torch.cuda.synchronize()
    t0 = time.time()
    st_s, an_s = gibbs.sequential_init(
        spec, py, shareds, mx.init(spec, shareds), small,
        torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    check_sweep(port, spec, py, shareds, small, st_s, an_s)
    state, an, log = runner.run_gibbs(
        spec, py, shareds, (X[:256],), torch.Generator().manual_seed(0), 1,
        block=64, use_pallas=True, sampling='gumbel', init='sequential')
    check_sweep(port, spec, py, shareds, (values[0][:256].contiguous(),),
                state, an)
    out['sequential'] = {
        'rows': n, 'sequential_init_seconds': seconds,
        'ms_per_row': 1e3 * seconds / n,
        'groups_after_init': int((st_s.counts > 0).sum()),
        'run_gibbs_rows': 256,
        'run_gibbs_groups': log.rows[-1]['nonempty_groups']}
    emit(out)


ROWS_SMALL = ROWS // 4
ROW_SHARDS = 4
MESH_2D = (2, 4)


def events_ms(fn):
    """(result, milliseconds by CUDA events) of one call."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def check_sharded(port, spec, py, shareds, values, state, assignments,
                  n_comp=1):
    """`check_sweep`, sample_size = rows, results on the card and, for a
    component-sharded state, an alive empty slot in every shard."""
    out = check_sweep(port, spec, py, shareds, values, state, assignments)
    R = assignments.shape[0]
    empties = (state.alive & (state.counts == 0)).reshape(n_comp, -1).sum(1)
    checks = {'sample_size': int(state.sample_size) == R,
              'on_the_card': assignments.device.type == 'cuda'
              and state.counts.device.type == 'cuda',
              'alive_empty_slot_per_shard': bool((empties >= 1).all())}
    if not all(checks.values()):
        raise AssertionError('sharded sweep output is wrong: %s' % checks)
    return dict(out, **checks)


def expect_launches(name, wrapper, want):
    if wrapper.launches != want:
        raise AssertionError('%s: %d launches, expected tiles x shards x '
                             'sweeps = %d' % (name, wrapper.launches, want))
    return want


# the sharded fused sweeps' graph checks: sweeps held bitwise to the eager
# loop, the draws of each mode in this order (the last one's graph is kept
# for the fresh-seed, profile and timing checks), and the sweeps (4 row
# shards) or calls (2-D) of each timed turn
SHARDED_SWEEPS = 10
SHARDED_MODES = ('argmax', 'cdf', 'gumbel')
MESH_2D_MODES = ('argmax', 'gumbel')
SHARDED_TIMED = 5


def sharded_graph_check(port, what, run, wrapper, want_launches, captures,
                        score_captures):
    """run() on the graph path, its launches of `wrapper` counted from 0
    (None: a sweep without a kernel), then under gibbs._eager_sweeps(),
    and the two held bitwise: (graph result, per-run report)."""
    gibbs = port['gibbs']
    stats = graph_counts(port)
    if wrapper is not None:
        wrapper.launches = 0
    g, g_ms = timed(run)
    counts = dict(stats)
    launches = 0 if wrapper is None else wrapper.launches
    with gibbs._eager_sweeps():
        e, e_ms = timed(run)
    want = {'captures': 1, 'replays': captures - 1,
            'score_captures': score_captures}
    if {k: counts[k] for k in want} != want or launches != want_launches:
        raise AssertionError('%s: counters %s and %d launches on the graph '
                             'path, expected %s and %d'
                             % (what, counts, launches, want, want_launches))
    report = {'equal': bits_equal(g, e), 'launches_graph_run': launches,
              'graph_ms': g_ms, 'eager_ms': e_ms,
              'capture_seconds': counts['capture_seconds'],
              'pool_bytes': counts['pool_bytes']}
    if not report['equal']:
        raise AssertionError('%s: the graph path and the eager loop differ'
                             % what)
    return g, report


def graph_seeds(graph):
    """What seeded a captured graph's last sweep, on the host: its seed
    table, or the seeds of its device generators."""
    import torch
    if graph.gens:
        return torch.tensor([g.initial_seed() for g in graph.gens])
    return graph.seeds.to('cpu', copy=True)


def sharded_fresh_seeds(port, what, call, n_seeds, gens=False):
    """Two one-sweep calls on a captured key with one generator: two
    replays with other seeds (the generator's table, or with `gens` the
    seed of the graph's device generator) and other draws, each equal to
    the eager sweep from the same generator."""
    import torch
    gibbs, rnd = port['gibbs'], port['random']
    gen, gen_e = (torch.Generator().manual_seed(11),
                  torch.Generator().manual_seed(11))
    stats = graph_counts(port)
    g1 = call(gen)
    graph = gibbs._GRAPH['graph']
    seeds1 = graph_seeds(graph)
    g2 = call(gen)
    seeds2 = graph_seeds(graph)
    with gibbs._eager_sweeps():
        e1, e2 = call(gen_e), call(gen_e)
    ref = torch.Generator().manual_seed(11)
    want = torch.tensor([rnd.draw_seed(ref)]) if gens else \
        rnd.sweep_seeds(ref, n_seeds)
    fresh = {
        'replays': stats['replays'] == 2 and stats['captures'] == 0,
        'seeds_differ': bool((seeds1 != seeds2).all()),
        'seeds_are_the_generators': bool(torch.equal(seeds1, want)),
        'draws_differ': not bool(torch.equal(g1[1], g2[1])),
        'first_equals_eager': bits_equal(g1, e1),
        'second_equals_eager': bits_equal(g2, e2)}
    if not all(fresh.values()):
        raise AssertionError('%s: fresh seeds: %s' % (what, fresh))
    return dict(fresh, rows_moved_between_replays=int((g1[1] != g2[1]).sum()))


def sharded_profile(port, what, call, want):
    """One replayed call under the profiler: the device ran exactly `want`
    split score + sample kernels (K1, K2 or K3) in it."""
    stats = graph_counts(port)
    prof = profile_sweep(call, ('split_score_sample',))
    seen = prof.get('kernel_calls', {}).get('split_score_sample')
    if seen != want or stats['captures'] or not stats['replays']:
        raise AssertionError('%s: the profile of a replayed sweep shows %r '
                             'score + sample kernels, expected %d (graph '
                             'counters %s, profile: %s)'
                             % (what, seen, want, dict(stats), prof))
    return prof


def graph_eager_turns(port, run, n):
    """ms per sweep of run() (n sweeps) on the graph path and eagerly, in
    turns: graph, eager, eager, graph."""
    gibbs = port['gibbs']
    by = {'graph': [], 'eager': []}
    for kind in ('graph', 'eager', 'eager', 'graph'):
        if kind == 'eager':
            with gibbs._eager_sweeps():
                by[kind].append(timed(run)[1] / n)
        else:
            by[kind].append(timed(run)[1] / n)
    return {'ms_per_sweep_graph': by['graph'],
            'ms_per_sweep_eager': by['eager']}


def phase_sharded(port, X, labels, mixed):
    """The sharded fused sweeps on in-process meshes at 1,048,576 rows x
    1024 slots, each sweep the replay of one CUDA graph of all its tiles
    and local shards (gibbs._SweepGraph), held bitwise to the eager loop
    with the seeds passed by value (gibbs._eager_sweeps) for 10 sweeps in
    every mode: sharded_sweep_fused on 4 row shards (nich2 on K1, niw2mix
    on K2) and sharded_sweep_2d_fused on 2 x 4 (niw2mix on K3).  Also:
    fresh seeds every replay, the profiler's exact kernel count in a
    replayed sweep, and ms/sweep on the graph and eagerly in turns.  Then
    the plain row-sharded, 2-D and component sweeps (eager by rule) on a
    quarter of the rows.  Returns K3's launches in the 2-D sweep's graph
    runs."""
    import torch
    fk, mx, gibbs, sharding = (port['fk'], port['mx'], port['gibbs'],
                               port['sharding'])
    out = {'phase': 'sharded', 'rows': ROWS, 'slots': SLOTS,
           'rows_small': ROWS_SMALL, 'sweeps_checked': SHARDED_SWEEPS,
           'note': 'logical shards on one card: overhead, not speed-up',
           'seconds': {}}
    t0 = time.time()

    def lap(name):
        out['seconds'][name] = round(time.time() - t0 - sum(
            out['seconds'].values()), 2)
    rows_mesh = sharding.make_mesh(ROW_SHARDS)
    problems = graph_problems(port, X, labels, mixed)
    for layout in ('nich2', 'niw2mix'):
        spec, py, shareds, values, a0, block, wrapper, _ = problems[layout]
        local = block // ROW_SHARDS
        tiles = ROWS // ROW_SHARDS // local
        st0 = mx.state_from_assignments(spec, py, shareds, values, a0)
        cache = gibbs.build_stat_cache(spec, shareds, values, local, a0)

        def call(mode='gumbel', n=1, gen=None, score=False):
            return sharding.sharded_sweep_fused(
                spec, py, shareds, st0, values, a0,
                gen or torch.Generator().manual_seed(7), rows_mesh, local,
                cache, block_rows=2048, sampling=mode, n_sweeps=n,
                with_score=score)
        res = {'shards': ROW_SHARDS, 'local_block': local,
               'tiles_per_shard': tiles}
        for mode in SHARDED_MODES:
            call(mode)      # the key's first call runs eagerly
            g, res[mode] = sharded_graph_check(
                port, 'sharded_sweep_fused %s %s' % (layout, mode),
                lambda: call(mode, SHARDED_SWEEPS, score=True), wrapper,
                tiles * ROW_SHARDS * SHARDED_SWEEPS, SHARDED_SWEEPS, 1)
        # the 'gumbel' graph is kept: its output checked, fresh seeds, a
        # profiled replay, timing
        checks = check_sharded(port, spec, py, shareds, values, g[0], g[1])
        if abs(float(g[3]) - checks['score_data']) > 1e-4 * abs(
                checks['score_data']):
            raise AssertionError('%s: with_score disagrees' % layout)
        res['checks'] = checks
        res['fresh_seeds'] = sharded_fresh_seeds(
            port, 'sharded %s' % layout, lambda gen: call(gen=gen),
            ROW_SHARDS * tiles)
        res['profile_replay'] = sharded_profile(
            port, 'sharded %s' % layout, call, tiles * ROW_SHARDS)
        res['timing'] = graph_eager_turns(
            port, lambda: call(n=SHARDED_TIMED), SHARDED_TIMED)
        cache1 = gibbs.build_stat_cache(spec, shareds, values, block, a0)

        def single():
            return gibbs.sweep_blocked_pallas_fused_mixed(
                spec, py, shareds, st0, values, a0, block, 2048,
                torch.Generator().manual_seed(7), cache1, sampling='gumbel',
                n_sweeps=SHARDED_TIMED)
        single()    # the key's first call runs eagerly,
        single()    # its second captures the graph: the timed one replays
        res['single_device_graph_ms_per_sweep'] = \
            timed(single)[1] / SHARDED_TIMED
        out['rows_fused_' + layout] = res
        del st0, cache, cache1
        lap('rows_fused_' + layout)

    # the un-kernelled row-sharded sweep, a quarter of the rows
    spec, py, shareds, values, a0, _, _, _ = problems['nich2']
    small = (values[0][:ROWS_SMALL].contiguous(),)
    a_s = a0[:ROWS_SMALL].contiguous()
    st_s = mx.state_from_assignments(spec, py, shareds, small, a_s)
    local = BLOCK_MIXED // ROW_SHARDS
    gen = torch.Generator().manual_seed(3)

    def blocked():
        return sharding.sharded_sweep_blocked(spec, py, shareds, st_s, small,
                                              a_s, gen, rows_mesh, local)
    blocked()
    (st, an), ms = events_ms(blocked)
    out['rows_blocked_nich2'] = dict(
        check_sharded(port, spec, py, shareds, small, st, an),
        rows=ROWS_SMALL, shards=ROW_SHARDS, local_block=local,
        ms_per_sweep=ms)
    del small, st_s, st, an

    # 2-D fused (K3) at full width; the generating clusters spread evenly
    # over the component shards' slot ranges, so that every shard has free
    # slots
    spec, py, shareds, values, a0, _, _, _ = problems['niw2mix']
    n_row, n_comp = MESH_2D
    per = -(-TRUE_CLUSTERS // n_comp)
    a0 = a0 + (a0 // per) * (SLOTS // n_comp - per)
    mesh2 = sharding.make_mesh_2d(n_row, n_comp)
    st0 = mx.state_from_assignments(spec, py, shareds, values, a0)
    sts0 = sharding.shard_state_components(st0, mesh2)
    local = BLOCK_MIXED // n_row
    tiles = ROWS // n_row // local
    per_sweep = tiles * n_row * n_comp

    def fused_2d(st, an, mode='gumbel', gen=None):
        st, an = sharding.sharded_sweep_2d_fused(
            spec, py, shareds, list(st), values, an,
            gen or torch.Generator().manual_seed(7), mesh2, local,
            sampling=mode)
        return tuple(st), an

    def chain(mode, n, gen):
        st, an = sts0, a0
        for _ in range(n):
            st, an = fused_2d(st, an, mode, gen)
        return st, an
    res = {'mesh': list(MESH_2D), 'C_local': SLOTS // n_comp,
           'local_block': local, 'tiles_per_row_shard': tiles}
    k3_launches = 0
    for mode in MESH_2D_MODES:
        fused_2d(sts0, a0, mode)    # the key's first call runs eagerly
        g, res[mode] = sharded_graph_check(
            port, 'sharded_sweep_2d_fused %s' % mode,
            lambda: chain(mode, SHARDED_SWEEPS,
                          torch.Generator().manual_seed(7)),
            fk.fused_score_sample_pair, per_sweep * SHARDED_SWEEPS,
            SHARDED_SWEEPS, 0)
        k3_launches += res[mode]['launches_graph_run']
    # the output checks on two sweeps from the generating labels, as
    # before the graph; after the ten above a shard may hold no empty slot
    # (its slots all taken), so only their count is recorded
    full = sharding.unshard_state_components(list(g[0]), mesh2)
    res['empty_slots_per_shard_after_%d' % SHARDED_SWEEPS] = (
        full.alive & (full.counts == 0)).reshape(n_comp, -1).sum(1).tolist()
    st2, an2 = chain('gumbel', 2, torch.Generator().manual_seed(7))
    res['checks'] = check_sharded(
        port, spec, py, shareds, values,
        sharding.unshard_state_components(list(st2), mesh2), an2, n_comp)
    del full, st2, an2
    res['fresh_seeds'] = sharded_fresh_seeds(
        port, 'sharded 2-D', lambda gen: fused_2d(sts0, a0, gen=gen),
        n_row * tiles)
    res['profile_replay'] = sharded_profile(
        port, 'sharded 2-D', lambda: fused_2d(sts0, a0), per_sweep)
    res['timing'] = graph_eager_turns(
        port, lambda: chain('gumbel', SHARDED_TIMED,
                            torch.Generator().manual_seed(7)),
        SHARDED_TIMED)
    out['fused_2d_niw2mix'] = res
    del st0, sts0
    lap('fused_2d_niw2mix')

    # the plain 2-D and component sweeps, and 'argmax' fused against plain,
    # on a quarter of the rows
    small = tuple(v[:ROWS_SMALL].contiguous() for v in values)
    a_s = a0[:ROWS_SMALL].contiguous()
    st_s = mx.state_from_assignments(spec, py, shareds, small, a_s)
    del values

    def small_sweep(fn, mesh, block, **kw):
        def run():
            return fn(spec, py, shareds, st_s, small, a_s, gen, mesh, block,
                      **kw)
        return run
    plain_2d = small_sweep(sharding.sharded_sweep_2d, mesh2, local)
    plain_2d()
    (st, an), ms = events_ms(plain_2d)
    out['plain_2d_niw2mix'] = dict(
        check_sharded(port, spec, py, shareds, small, st, an, n_comp),
        rows=ROWS_SMALL, mesh=list(MESH_2D), local_block=local,
        ms_per_sweep=ms)
    comp_mesh = sharding.make_component_mesh(n_comp)
    comps = small_sweep(sharding.sharded_sweep_components, comp_mesh, local)
    comps()
    (st, an), ms = events_ms(comps)
    out['components_niw2mix'] = dict(
        check_sharded(port, spec, py, shareds, small, st, an, n_comp),
        rows=ROWS_SMALL, shards=n_comp, block=local, ms_per_sweep=ms)
    st_x, an_x = small_sweep(sharding.sharded_sweep_2d, mesh2, local,
                             sampling='argmax')()
    st_f, an_f = small_sweep(sharding.sharded_sweep_2d_fused, mesh2, local,
                             sampling='argmax')()
    # the plain sweep scores with the models' score_value_batch formulas
    # and K3 with the product-form coefficient rows: equal to f32 rounding,
    # so an 'argmax' draw can differ only at a near-tie.  The draws must
    # agree but for at most one row in 10,000, and the counts by no more
    # than those rows move (tests/test_torch_cuda.py and the CPU tests hold
    # the two to exact equality on separated clusters).
    differ = int((an_x != an_f).sum())
    moved = int((st_x.counts - st_f.counts).abs().sum())
    out['argmax_2d_fused_vs_plain'] = {
        'rows': ROWS_SMALL, 'draws_differ': differ,
        'allowed': ROWS_SMALL // 10000, 'counts_l1_difference': moved}
    lap('plain')
    emit(out)
    if differ > ROWS_SMALL // 10000 or moved > 2 * differ:
        raise AssertionError("'argmax' 2-D fused differs from 'argmax' 2-D "
                             'plain in %d rows (counts moved %d)'
                             % (differ, moved))
    return k3_launches


def phase_main_mesh(port, X, labels):
    """run_gibbs(mesh=...) through the normal entry point on 4 row shards,
    nich2 at full width, with a checkpoint: every sweep but the first is
    the replay of the step's CUDA graph, and the device ran exactly the
    launches counted in the profiled last step; then an interrupted and
    resumed run against it, bitwise."""
    import shutil
    import tempfile
    import torch
    fk, mx, runner, sharding = (port['fk'], port['mx'], port['runner'],
                                port['sharding'])
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    mesh = sharding.make_mesh(ROW_SHARDS)
    local = BLOCK // ROW_SHARDS
    passes, per_step = 9, 3
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        def run(n, path, seed, resume, log=None):
            return runner.run_gibbs(
                spec, py, shareds, (X,), torch.Generator().manual_seed(seed),
                n, block=local, use_pallas=True, sampling='gumbel',
                grow_headroom=0.0, checkpoint_every=per_step,
                sweeps_per_step=per_step, initial_assignments=labels,
                mesh=mesh, checkpoint_path=os.path.join(tmp, path),
                resume=resume, log=log)
        steps = passes // per_step
        per_sweep = (ROWS // ROW_SHARDS // local) * ROW_SHARDS
        torch.cuda.synchronize()
        fk.fused_score_sample_stats.launches = 0
        stats = graph_counts(port)
        log = last_step_profiler(port, steps, fk.fused_score_sample_stats)
        t0 = time.time()
        st_a, an_a, log_a = run(passes, 'full.ckpt', 5, False, log)
        torch.cuda.synchronize()
        wall = time.time() - t0
        last = log.stop()
        launches = expect_launches(
            'run_gibbs(mesh)', fk.fused_score_sample_stats,
            per_sweep * passes)
        graphs = expect_graph('run_gibbs(mesh)', stats, passes, steps)
        seen = last.get('kernel_calls', {}).get('split_score_sample')
        if not seen == last['launches_counted'] == per_sweep * per_step:
            raise AssertionError(
                'run_gibbs(mesh): in its last step the device ran %r score '
                '+ sample kernels and the wrapper counted %d launches, '
                'expected shards x tiles x sweeps = %d (profile: %s)'
                % (seen, last['launches_counted'], per_sweep * per_step,
                   last))
        values = (torch.as_tensor(X, device=an_a.device),)
        checks, score = check_run(port, spec, py, shareds, values, st_a, an_a,
                                  log_a)
        run(per_step, 'crash.ckpt', 5, False)
        st_b, an_b, log_b = run(passes, 'crash.ckpt', 999, True)
        resume = {
            'assignments_equal': bool(torch.equal(an_a, an_b)),
            'counts_equal': bool(torch.equal(st_a.counts, st_b.counts)),
            'stats_equal': all(bool(torch.equal(x, y)) for x, y in zip(
                st_a.groups[0], st_b.groups[0])),
            'score_equal': log_a.rows[-1]['score_data']
                == log_b.rows[-1]['score_data'],
            'sweeps_continuous': [r['sweep'] for r in log_b.rows]
                == list(range(per_step - 1, passes, per_step))}
        if not all(resume.values()):
            raise AssertionError('resume under a mesh is not bitwise: %s'
                                 % resume)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = [r['seconds'] for r in log_a.rows]
    emit({'phase': 'main_mesh', 'rows': ROWS, 'slots': SLOTS,
          'shards': ROW_SHARDS, 'local_block': local, 'sweeps': passes,
          'sweeps_per_step': per_step, 'launches': launches,
          'graphs': graphs, 'last_step_profile': last,
          'step_seconds': steps, 'wall_seconds': round(wall, 3),
          # the first step captures the graph, the last is profiled
          'ms_per_sweep_steady_step': 1e3 * steps[1] / per_step,
          'score_data': score, 'checks': checks, 'resume': resume})


def phase_process_group(port, X, labels):
    """A torch.distributed group of one rank with NCCL on the card: the
    row-sharded fused sweep on the global mesh, its sweeps after the first
    replayed from a CUDA graph that holds the NCCL all_reduce (the key's
    eager first call makes the communicator before the capture), against
    its eager loop and the single-device fused sweep, bitwise.  More than
    one rank needs more than one card."""
    import socket
    import torch
    import torch.distributed as dist
    mx, gibbs, sharding, distributed = (port['mx'], port['gibbs'],
                                        port['sharding'], port['distributed'])
    dev = port['config'].default_device()
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    values = (torch.as_tensor(X[:ROWS_SMALL], device=dev),)
    a0 = torch.as_tensor(labels[:ROWS_SMALL], device=dev)
    st0 = mx.state_from_assignments(spec, py, shareds, values, a0)
    cache = gibbs.build_stat_cache(spec, shareds, values, BLOCK_MIXED, a0)
    sock = socket.socket()
    sock.bind(('localhost', 0))
    port_no = sock.getsockname()[1]
    sock.close()
    distributed.initialize('localhost:%d' % port_no, 1, 0, timeout=120)
    n = 3
    try:
        backend = dist.get_backend()
        mesh = distributed.make_global_mesh()

        def sharded(k):
            return sharding.sharded_sweep_fused(
                spec, py, shareds, st0, values, a0,
                torch.Generator().manual_seed(8), mesh, BLOCK_MIXED, cache,
                sampling='gumbel', n_sweeps=k, with_score=True)
        sharded(1)      # the key's first call runs eagerly
        stats = graph_counts(port)
        g, g_ms = timed(lambda: sharded(n))
        counts = dict(stats)
        with gibbs._eager_sweeps():
            e, e_ms = timed(lambda: sharded(n))
        # an all_reduce that changes its input, to see that NCCL ran
        probe = mesh.psum([torch.arange(4, device=dev)], sharding.ROWS)[0]
        torch.cuda.synchronize()
    finally:
        gibbs.release_sweep_graphs()
        distributed.shutdown()
    one = gibbs.sweep_blocked_pallas_fused_mixed(
        spec, py, shareds, st0, values, a0, BLOCK_MIXED, 2048,
        torch.Generator().manual_seed(8), cache, sampling='gumbel',
        n_sweeps=n, with_score=True)
    checks = {'backend_is_nccl': backend == 'nccl',
              'group_per_axis': sharding.ROWS in mesh.groups,
              'replayed': counts['captures'] == 1
              and counts['replays'] == n - 1,
              'graph_equals_eager': bits_equal(g, e),
              'graph_equals_single_device': bits_equal(g, one),
              'psum_of_one_rank': probe.tolist() == [0, 1, 2, 3],
              'group_destroyed': not dist.is_initialized()}
    emit({'phase': 'process_group', 'backend': backend, 'world_size': 1,
          'rows': ROWS_SMALL, 'sweeps': n, 'checks': checks,
          'graph': {k: counts[k] for k in ('captures', 'replays',
                                           'capture_seconds', 'pool_bytes')},
          'graph_ms': g_ms, 'eager_ms': e_ms,
          'note': 'more than one rank was not run: one card'})
    if not all(checks.values()):
        raise AssertionError('process-group mesh: %s' % checks)


def tile_bookkeeping_ms(port, spec, py, shareds, state, values, cache):
    """Host wall milliseconds (ending in a synchronize, median of 5) of the
    [C]-sized work the fused sweep does around each K2 launch."""
    import torch
    fk, mx, gibbs, cl = port['fk'], port['mx'], port['gibbs'], port['cl']
    lay = gibbs._mixed_static_layout(spec, values)
    tiles = mx.sums_to_tiles(spec, shareds, tuple(s[0] for s in cache[1]))

    def wall_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.time() - t0))
        return sorted(times)[2]
    return {
        'cl_score_value': wall_ms(lambda: cl.score_value(
            py, state.counts, state.alive, state.sample_size)),
        'niw_coeffs_v4': wall_ms(lambda: fk.niw_coeffs_v4(
            shareds[0], state.groups[0])),
        'nich_coeffs_v2': wall_ms(lambda: fk.nich_coeffs_v2(
            shareds[1], state.groups[1])),
        'build_fused_inputs': wall_ms(lambda: gibbs._build_fused_inputs(
            spec, lay, shareds, state)),
        'sums_to_tiles': wall_ms(lambda: mx.sums_to_tiles(
            spec, shareds, tuple(s[0] for s in cache[1]))),
        'apply_stat_tiles_remove': wall_ms(lambda: mx.apply_stat_tiles(
            spec, shareds, state, cache[0][0], tiles, -1, BLOCK_MIXED)),
        'apply_stat_tiles_add': wall_ms(lambda: mx.apply_stat_tiles(
            spec, shareds, state, cache[0][0], tiles, +1, BLOCK_MIXED)),
        'layout_per_call': wall_ms(lambda: gibbs._mixed_static_layout(
            spec, values)),
    }


# -- samplers, the LowEntropy prior, the other moves -------------------------

SAMPLER_DRAWS = ROWS
WISHART_DRAWS = 65536
GROUP_DRAWS = 65536
# the last values of a sample_group held against the predictive of a group
# of its first values (testing.sample_group_z)
GROUP_FIT = 4096
GROUP_TEST = 512
LE = {'dataset_size': ROWS}
LE_STEPS = 2
LE_SWEEPS_PER_STEP = 5
MH_BLOCK = 131072
MH_STEPS = 4
SPLIT_MERGE_MOVES = 20
RESTRICTED_MOVES = 3
# restricted moves from random labels stop at the first accepted one
RESTRICTED_TRIES = 24
SEQUENTIAL_ROWS = 4096
CHAINS = 4
CHAIN_ROWS = 65536
CHAIN_BLOCK = 16384


def ztest(x, mean, var):
    """|z| of the mean of the draws `x` against `mean`, per-draw variance
    `var`."""
    x = x.double()
    return abs(float(x.mean()) - mean) / (var / x.numel()) ** 0.5


def draws_per_sec(fn, n):
    return n / (cuda_ms(fn, 3) / 1e3)


def phase_samplers(port):
    """Every random.py sampler at 1,048,576 draws (the Wishart family at
    65,536 draws of d = 2-4), z-tested against closed forms and timed;
    the clustering samplers; each model's sample_group at 65,536 values
    held against its own predictive score."""
    import numpy as np
    import torch
    rnd, cl, testing, models = (port['random'], port['cl'], port['testing'],
                                port['models'])
    dev = port['config'].default_device()
    n = SAMPLER_DRAWS
    gen = torch.Generator(device=dev).manual_seed(0)

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    # (name, draw, checks as (draws -> statistic, mean, variance), draws a
    # call)
    cases = [
        ('unif01', lambda: rnd.sample_unif01(gen, (n,), device=dev),
         [(lambda x: x, 0.5, 1 / 12)], n),
        ('int', lambda: rnd.sample_int(gen, 3, 9, (n,), device=dev),
         [(lambda x: x, 5.5, 35 / 12)], n),
        ('bernoulli', lambda: rnd.sample_bernoulli(gen, t(0.3), (n,)),
         [(lambda x: x, 0.3, 0.21)], n),
        ('normal', lambda: rnd.sample_normal(gen, t(1.5), 2.0, (n,)),
         [(lambda x: x, 1.5, 4.0), (lambda x: (x - 1.5) ** 2, 4.0, 32.0)],
         n),
        ('std_normal', lambda: rnd.sample_std_normal(gen, (n,), device=dev),
         [(lambda x: x, 0.0, 1.0)], n),
        ('chisq', lambda: rnd.sample_chisq(gen, t(3.7), (n,)),
         [(lambda x: x, 3.7, 7.4)], n),
        ('gamma', lambda: rnd.sample_gamma(gen, t(2.5), 1.7, (n,)),
         [(lambda x: x, 4.25, 2.5 * 1.7 ** 2)], n),
        ('gamma_small_shape', lambda: rnd.sample_gamma(gen, t(0.3), 1.0,
                                                       (n,)),
         [(lambda x: x, 0.3, 0.3)], n),
        ('beta', lambda: rnd.sample_beta(gen, t(2.0), 5.0, (n,)),
         [(lambda x: x, 2 / 7, 10 / (49 * 8))], n),
        ('beta_small_shapes', lambda: rnd.sample_beta(gen, t(0.2), 0.3,
                                                      (n,)),
         [(lambda x: x, 0.4, 0.06 / (0.25 * 1.5))], n),
        ('beta_safe', lambda: rnd.sample_beta_safe(gen, t(2.0), 5.0,
                                                   shape=(n,)),
         [(lambda x: x, 2 / 7, 10 / (49 * 8))], n),
        ('poisson', lambda: rnd.sample_poisson(gen, t(3.3), (n,)),
         [(lambda x: x, 3.3, 3.3)], n),
        ('negative_binomial',
         lambda: rnd.sample_negative_binomial(gen, t(0.4), 3, (n,)),
         [(lambda x: x, 4.5, 3 * 0.6 / 0.16)], n),
        ('dirichlet', lambda: rnd.sample_dirichlet(
            gen, t([0.5, 2.0, 3.5]), (n,)),
         [(lambda x: x[:, 0], 0.5 / 6, (0.5 / 6) * (5.5 / 6) / 7),
          (lambda x: x[:, 2], 3.5 / 6, (3.5 / 6) * (2.5 / 6) / 7)], n),
        ('discrete', lambda: rnd.sample_discrete(
            gen, t([0.1, 0.3, 0.05, 0.55]), (n,)),
         [(lambda x: x == 3, 0.55, 0.55 * 0.45),
          (lambda x: x == 2, 0.05, 0.05 * 0.95)], n),
        ('from_scores', lambda: rnd.sample_from_scores(
            gen, torch.log(t([0.1, 0.3, 0.05, 0.55])), (n,)),
         [(lambda x: x == 1, 0.3, 0.21)], n),
        ('student_t', lambda: rnd.sample_student_t(
            gen, 5.0, t([0.5]), t([[1.5]]), (n,)),
         [(lambda x: x[:, 0], 0.5, 1.5 * 5 / 3)], n),
        ('multivariate_normal', lambda: rnd.sample_multivariate_normal(
            gen, t([0.5, -1.0, 0.0]), t([[1.0, 0.6, 0.0], [0.6, 2.0, 0.0],
                                         [0.0, 0.0, 0.5]]), (n,)),
         [(lambda x: x[:, 1], -1.0, 2.0),
          (lambda x: x[:, 0] * x[:, 1], 0.6 - 0.5, None)], n),
    ]
    for d in (2, 3, 4):
        lam = np.eye(d) + 0.2
        var = 7.0 * (lam ** 2 + np.outer(np.diag(lam), np.diag(lam)))
        cases.append((
            'wishart_d%d' % d,
            lambda d=d, lam=lam: rnd.sample_wishart(
                gen, 7.0, t(lam.tolist()), (WISHART_DRAWS,)),
            [(lambda x: x[:, 0, 0], 7.0 * lam[0, 0], var[0, 0]),
             (lambda x, d=d: x[:, 0, d - 1], 7.0 * lam[0, d - 1],
              var[0, d - 1])],
            WISHART_DRAWS))
        nu = d + 8.0
        p = nu - d
        S = 2 * np.eye(d)
        iw_var = 2 * 4 / ((p - 1) ** 2 * (p - 3))
        cases.append((
            'inverse_wishart_d%d' % d,
            lambda d=d, nu=nu, S=S: rnd.sample_inverse_wishart(
                gen, nu, t(S.tolist()), (WISHART_DRAWS,)),
            [(lambda x: x[:, 0, 0], 2 / (p - 1), iw_var)], WISHART_DRAWS))
        cases.append((
            'normal_inverse_wishart_d%d' % d,
            lambda d=d, nu=nu, S=S: torch.cat([
                m.reshape(WISHART_DRAWS, -1) for m in
                rnd.sample_normal_inverse_wishart(
                    gen, t([1.0] * d), 2.0, t(S.tolist()), nu,
                    (WISHART_DRAWS,))], 1),
            [(lambda x: x[:, 0], 1.0, (2 / (p - 1)) / 2.0),
             (lambda x, d=d: x[:, d], 2 / (p - 1), iw_var)],
            WISHART_DRAWS))
    results = {}
    worst = 0.0
    for name, draw, checks, count in cases:
        x = draw()
        if x.device.type != dev.type or not bool(torch.isfinite(
                x.to(torch.float32)).all()):
            raise AssertionError('sampler %s: not finite draws on the card'
                                 % name)
        zs = []
        for stat, mean, var in checks:
            s = stat(x.to(torch.float64))
            zs.append(ztest(s, mean, var if var is not None
                            else float(s.var())))
        worst = max(worst, max(zs))
        if max(zs) >= Z_MAX:
            raise AssertionError('sampler %s: |z| %s' % (name, zs))
        results[name] = {'draws': count, 'z': max(zs),
                         'draws_per_sec': draws_per_sec(draw, count)}

    # the clustering samplers: the stick sampler against the host-seated
    # sequential law by the occupied-table count, over repeated draws
    py = cl.PitmanYor.from_dict(PY)
    reps = 16
    k_stick, k_seq = [], []
    for _ in range(reps):
        k_stick.append(int(torch.unique(cl.py_sample_assignments_stick(
            gen, py, ROWS, SLOTS)).numel()))
        k_seq.append(int(torch.unique(cl.py_sample_assignments(
            gen, py, ROWS, SLOTS)).numel()))
    a, b = np.array(k_stick, float), np.array(k_seq, float)
    z_tables = abs(a.mean() - b.mean()) / np.sqrt(
        (a.var(ddof=1) + b.var(ddof=1)) / reps)
    if z_tables >= Z_MAX:
        raise AssertionError('stick and sequential seating disagree on the '
                             'table count: %s vs %s' % (k_stick, k_seq))
    le = cl.LowEntropy.from_dict({'dataset_size': 300})
    le_a = cl.le_sample_assignments(gen, le, 300, 64)
    torch.cuda.synchronize()
    t0 = time.time()
    seq_a = cl.py_sample_assignments(gen, py, ROWS, SLOTS)
    torch.cuda.synchronize()
    seq_s = time.time() - t0
    clustering = {
        'stick_tables': k_stick, 'sequential_tables': k_seq,
        'table_count_z': float(z_tables),
        'stick_draws_per_sec': draws_per_sec(
            lambda: cl.py_sample_assignments_stick(gen, py, ROWS, SLOTS),
            ROWS),
        'sequential_host_draws_per_sec': ROWS / seq_s,
        'sequential_on_the_card': seq_a.device.type == dev.type,
        'le_items': 300, 'le_groups': int(torch.unique(le_a).numel()),
        'le_draws_per_sec': draws_per_sec(
            lambda: cl.le_sample_assignments(gen, le, 300, 64), 300)}

    # each model's sample_group against its own predictive
    groups = {}
    for name, module in sorted(models.items()):
        raw = module.EXAMPLES[-1]['shared']
        shared = module.shared_from_dict(raw)
        if name == 'dpd':
            shared = module.shared_realize(gen, shared)
        values = module.sample_group(gen, shared, GROUP_DRAWS)
        z = testing.sample_group_z(module, shared, values, GROUP_TEST,
                                   GROUP_FIT)
        if values.device.type != dev.type or z >= Z_MAX:
            raise AssertionError('%s.sample_group: |z| %r' % (name, z))
        groups[name] = {'z': z, 'draws_per_sec': draws_per_sec(
            lambda m=module, s=shared: m.sample_group(gen, s, GROUP_DRAWS),
            GROUP_DRAWS)}
    emit({'phase': 'samplers', 'z_max': Z_MAX, 'worst_z': worst,
          'samplers': results, 'clustering': clustering,
          'sample_group': groups})


def additive_leaves(module, group):
    """A Group's leaves in additive form, as the stat cache carries them:
    nich's (count, mean, count_times_variance) as (count, sum, sum of
    squares); every other model's Group is additive already."""
    if module.__name__.endswith('.nich'):
        n = group.count.to(group.mean.dtype)
        return (group.count, group.mean * n,
                group.count_times_variance + n * group.mean * group.mean)
    return tuple(group)


def check_state(port, spec, cl_model, shareds, values, state, assignments,
                what, updates=0):
    """The state equals state_from_assignments of its assignments: counts,
    the alive mask and integer stats exactly, float stats in their
    additive form within rtol 1e-5 / atol 1e-3 (nich's count_times_variance
    is a difference of two such sums, ~1e4 each at this data's means, and
    carries their rounding); score_data within 1e-4 of a fresh recompute.
    `updates`: the incremental tile updates (an unmerge and a merge a tile
    and sweep) that each slot's float stats went through since they were
    built from the assignments.  Each rounds in f32, in the JAX package's
    runner as in the port's, so a float leaf may also differ by updates x
    2^-24 x its largest magnitude (0: the tolerance above alone, which
    holds over about ten sweeps).  Returns (fresh score, the largest float
    difference of each form)."""
    import torch
    mx = port['mx']
    fresh = mx.state_from_assignments(spec, cl_model, shareds, values,
                                      assignments)
    ok = torch.equal(state.counts, fresh.counts) and torch.equal(
        state.alive, fresh.alive)
    worst = {'additive': 0.0, 'group': 0.0}
    for block, g, f in zip(spec.blocks, state.groups, fresh.groups):
        for form, a_leaves, b_leaves in (
                ('additive', additive_leaves(block.module, g),
                 additive_leaves(block.module, f)), ('group', g, f)):
            for a, b in zip(a_leaves, b_leaves):
                if not a.dtype.is_floating_point:
                    ok = ok and torch.equal(a, b)
                    continue
                worst[form] = max(worst[form],
                                  float((a - b).abs().max()))
                if form == 'additive':
                    drift = updates * 2.0 ** -24 * float(b.abs().max())
                    ok = ok and torch.allclose(a, b, rtol=SUM_RTOL,
                                               atol=SUM_ATOL + drift)
    score = float(mx.score_data(spec, cl_model, shareds, state))
    want = float(mx.score_data(spec, cl_model, shareds, fresh))
    if not (ok and abs(score - want) <= 1e-4 * abs(want)):
        raise AssertionError('%s: the state is not state_from_assignments '
                             'of its assignments (stats ok %s, largest '
                             'differences %s, score %r, fresh %r)'
                             % (what, ok, worst, score, want))
    return want, worst


def le_tile_argmax(port, spec, le, shareds, values, assignments, block):
    """Tile 0 of a fused sweep in 'argmax' against the plain path's
    argmax of mixture.score_batch on the same tile-removed state: equal
    draws but at near-ties."""
    import torch
    mx, gibbs, testing = port['mx'], port['gibbs'], port['testing']
    state = mx.state_from_assignments(spec, le, shareds, values,
                                      assignments)
    cd, sums = gibbs.build_stat_cache(spec, shareds, tuple(
        v[:block] for v in values), block, assignments[:block])
    tiles = mx.sums_to_tiles(spec, shareds, tuple(s[0] for s in sums))
    state = mx.apply_stat_tiles(spec, shareds, state, cd[0], tiles, -1,
                                block)
    lay = gibbs._mixed_static_layout(spec, values)
    got, _, _ = gibbs._fused_tile_core(
        spec, lay, gibbs._stat_matrices(spec, lay, shareds), 2048, 'argmax',
        le, shareds, state, *gibbs._slice_rows(lay, 0, block), 0)
    scores = mx.score_batch(spec, le, shareds, state,
                            tuple(v[:block] for v in values))
    n_bad, gap = testing.mismatches(scores, got, torch.argmax(scores, 1))
    if gap > TIE_GAP or n_bad > block // 1000:
        raise AssertionError('LowEntropy tile: %d draws differ from the '
                             'plain argmax, gap %r' % (n_bad, gap))
    return {'rows': block, 'mismatches': n_bad, 'max_gap': gap}


def phase_main_le(port, X, labels, mixed):
    """run_gibbs(use_pallas=True) with LowEntropy{dataset_size=1,048,576}
    on nich2 (K1) and niw2mix (K2) at 1,048,576 rows x 1024 slots from the
    generating labels, 2 steps of 5 sweeps; each kernel's count set to 0
    just before its run and read just after.  Returns the launches of K1
    and K2."""
    import torch
    fk, mx, gibbs, testing = (port['fk'], port['mx'], port['gibbs'],
                              port['testing'])
    le = port['cl'].LowEntropy.from_dict(LE)
    py = port['cl'].PitmanYor.from_dict(PY)
    passes = LE_STEPS * LE_SWEEPS_PER_STEP
    launches = []
    for layout, kernel, block in (('nich2', fk.fused_score_sample_stats,
                                   BLOCK),
                                  ('niw2mix',
                                   fk.fused_mixed_score_sample_stats,
                                   BLOCK_MIXED)):
        if layout == 'nich2':
            spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
            shareds = (port['nich'].shared_from_dict(SHARED),)
            values_np, labels_np = (X,), labels
        else:
            spec, _, shareds = testing.build_problem(
                mixed, port['models'], mx.make_spec,
                port['cl'].PitmanYor.from_dict)
            values_np, labels_np = mixed['values'], mixed['labels']
        torch.cuda.synchronize()
        kernel.launches = 0
        stats = graph_counts(port)
        t0 = time.time()
        state, an, log = port['runner'].run_gibbs(
            spec, LE, shareds, values_np, torch.Generator().manual_seed(0),
            passes, block=block, use_pallas=True, sampling='gumbel',
            initial_assignments=labels_np, grow_headroom=0.0,
            sweeps_per_step=LE_SWEEPS_PER_STEP)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = kernel.launches
        if n != ROWS // block * passes:
            raise AssertionError('main_le %s: %d launches, expected tiles x '
                                 'sweeps = %d' % (layout, n,
                                                  ROWS // block * passes))
        launches.append(n)
        graphs = expect_graph('main_le ' + layout, stats, passes, LE_STEPS)
        values = tuple(torch.as_tensor(v, device=an.device)
                       for v in values_np)
        fresh, worst = check_state(port, spec, le, shareds, values, state,
                                   an, 'main_le ' + layout)
        score = log.rows[-1]['score_data']
        if not abs(score - fresh) <= 1e-4 * abs(fresh):
            raise AssertionError('main_le %s: logged score %r, fresh %r'
                                 % (layout, score, fresh))
        steps = [r['seconds'] for r in log.rows]
        cache = gibbs.build_stat_cache(spec, shareds, values, block, an)
        gen = torch.Generator().manual_seed(1)

        def sweep(cl_model):
            return gibbs.sweep_blocked_pallas_fused_mixed(
                spec, cl_model, shareds, state, values, an, block, 2048, gen,
                cache, sampling='gumbel')
        # a key's first call runs eagerly and its second captures the
        # graph: the profile sees a replay
        sweep(le)
        sweep(le)
        profile = profile_sweep(
            lambda: sweep(le), ('split_score_sample', 'fused_v2'
                                if layout == 'nich2' else 'fused_v3'))
        # one fused sweep under each prior on this state, in turns (PY,
        # LE, LE, PY), three replays a turn: what the prior alone costs a
        # sweep.  The prior's type is part of the graph's key, so a turn
        # first captures its own graph (two calls)
        by_prior = {'PitmanYor': [], 'LowEntropy': []}
        for model in (py, le, le, py):
            sweep(model)
            sweep(model)
            for _ in range(3):
                by_prior[type(model).__name__].append(
                    timed(lambda: sweep(model))[1])
        emit({'phase': 'main_le', 'layout': layout, 'rows': ROWS,
              'slots': SLOTS, 'block': block, 'prior': LE,
              'sweeps': passes, 'sweeps_per_step': LE_SWEEPS_PER_STEP,
              'launches': n, 'graphs': graphs, 'step_seconds': steps,
              'wall_seconds': round(wall, 3),
              'ms_per_sweep': 1e3 * steps[-1] / LE_SWEEPS_PER_STEP,
              'nonempty_groups': log.rows[-1]['nonempty_groups'],
              'score_data': score, 'fresh_score_data': fresh,
              'state_largest_differences': worst,
              'tile_argmax': le_tile_argmax(port, spec, le, shareds, values,
                                            an, block),
              'fused_sweep_profile': profile,
              'one_sweep_wall_ms_by_prior': {
                  k: sorted(v)[len(v) // 2] for k, v in by_prior.items()},
              'one_sweep_wall_ms_turns': by_prior})
    return launches


# -- the JAX package's documented runner configurations ----------------------

REF_SPS = 50            # benchmarks/bench_runner.py's sweeps a step
REF_BLOCK = 131072
REF_SLOTS = 8192        # bench.py with BENCH_COMPONENTS=8192 (BENCH.md)
# (line, bench_runner model, nich columns, slots, steps, generating
# clusters as (num, den) of the slots).  The JAX runner's 7C/8 where the
# port's runner holds it; on an H100 nich2 at 1024 slots from 7C/8 ended
# its first step with 1022 groups and its second with none free (the
# runner's refusal), nich1 ended its two steps with 1022 and 1023: both
# run from 3C/4, bench_runner's default.  At 8192 slots 7168 clusters
# merge (5419 and 3645 groups after the two steps); bb1 holds ~900.
REF_CONFIGS = (
    ('nich2_sps50', 'nich', 2, SLOTS, 3, (3, 4)),
    ('nich2_c8192', 'nich', 2, REF_SLOTS, 2, (7, 8)),
    ('nich1_sps50', 'nich', 1, SLOTS, 2, (3, 4)),
    ('bb1_sps50', 'bb', 1, SLOTS, 2, (7, 8)))
# chained sweeps of each 8192-slot path, graph against eager
REF_PATH_SWEEPS = {'v1': 3, 'plain': 2, 'fused_2d': 3}
REF_DET_MODES = ('argmax', 'gumbel_host')


def reference_problem(port, model, cols, C, frac):
    """bench_runner's problem of `model` at ROWS rows and C slots, with
    frac = (num, den) of the slots as generating clusters: (spec, prior,
    shareds, numpy values, numpy labels, generating clusters)."""
    num, den = frac
    n_true = C // den * num
    return port['bench_runner'].problem(model, ROWS, C, n_true, cols) + (
        n_true,)


def reference_run(port, name, model, cols, C, steps, frac):
    """One configuration through run_gibbs(use_pallas=True) at full width,
    REF_SPS sweeps a step, warm from the generating labels,
    grow_headroom=0, 'gumbel': run_main's launch, graph and profile
    checks, check_state, the logged score against a recompute, capacity
    unchanged.  Returns (line, problem on the card, launches)."""
    import statistics
    import torch
    fk = port['fk']
    spec, py, shareds, values_np, labels, n_true = reference_problem(
        port, model, cols, C, frac)
    wrapper = fk.fused_mixed_score_sample_stats if model == 'bb' \
        else fk.fused_score_sample_stats
    state, assignments, log, run = run_main(
        port, wrapper, spec, py, shareds, values_np, labels, REF_BLOCK,
        steps=steps, sweeps_per_step=REF_SPS)
    dev = assignments.device
    values = tuple(torch.as_tensor(v, device=dev) for v in values_np)
    # every slot's float stats take an unmerge and a merge a tile and sweep
    updates = 2 * ROWS // REF_BLOCK * steps * REF_SPS
    fresh, worst = check_state(port, spec, py, shareds, values, state,
                               assignments, name, updates)
    score = log.rows[-1]['score_data']
    checks = {
        'capacity_unchanged': state.counts.shape[0] == C,
        'range': bool(((assignments >= 0) & (assignments < C)).all()),
        'on_the_card': dev.type == 'cuda',
        'finite': math.isfinite(score),
        'fresh_score': abs(score - fresh) <= 1e-4 * abs(fresh)}
    if not all(checks.values()):
        raise AssertionError('%s: the run is wrong: %s (score %r, fresh %r)'
                             % (name, checks, score, fresh))
    last = run.pop('last_step_profile')
    ms = 1e3 * statistics.median(run['step_seconds'][1:]) / REF_SPS
    features = cols if model == 'nich' else len(spec.blocks)
    # the profiled last step: REF_SPS replayed sweeps and one replay of the
    # step's score graph (in 'rest'), per sweep
    split = {'device_ms': last['device_ms'] / REF_SPS,
             'split_kernel_ms': last['kernel_device_ms'] / REF_SPS,
             'stat_stage_ms': last['stat_stage_device_ms'] / REF_SPS}
    split['rest_ms'] = split['device_ms'] - split['split_kernel_ms'] \
        - split['stat_stage_ms']
    line = dict(run, phase='reference_configs', config=name, model=model,
                features=features, generating_clusters=n_true,
                ms_per_sweep_median=ms,
                cells_per_sec=float(ROWS) * C * features / (ms / 1e3),
                device_split_per_sweep=split,
                busy_share_profiled_step=last['device_busy_share'],
                profiled_step=last,
                nonempty_groups_per_step=[r['nonempty_groups']
                                          for r in log.rows],
                final_capacity=int(state.counts.shape[0]),
                score_data=score, fresh_score_data=fresh,
                state_max_float_difference=worst,
                state_float_updates=updates, checks=checks)
    del state, assignments, log
    labels = torch.as_tensor(labels, device=dev)
    return line, (spec, py, shareds, values, labels, n_true), run['launches']


def reference_kernel(port, launch, plain, modes, philox, bd, B, C):
    """A kernel against its twin at one input of the 8192-slot problems:
    `modes` {mode: compare_mode-style result}, 'gumbel' on its Philox
    noise (`philox`), then milliseconds of the kernel ('gumbel', the seed
    read from device memory as the sweeps' graphs launch it) and of its
    twin, and its shares of the nominal and measured bounds (`bd`)."""
    import torch
    seed_t = torch.tensor([3], device=port['config'].default_device())
    ms = cuda_ms(lambda: launch('gumbel', None, seed_t), 7)
    return dict(bd, B=B, C=C, modes=modes, philox_exact=philox, ms=ms,
                plain_ms=cuda_ms(lambda: plain('gumbel', None, 3), 3),
                nominal_bound_share=bd['bound_ms'] / ms,
                measured_bound_share=bd['measured_bound_ms'] / ms)


# Philox words of slots g >= 4096 come from counter words q = g / 4 >= 1024
PHILOX_HIGH_SLOT = 4096


def reference_kernels(port, problem):
    """K1, K2 (bb), K3 (the 2 x 4 mesh's four slot shards, the last one
    timed) and K4 at 8192 slots (K2 also at 1024) on the main path's
    first tile, each against its twin in 'argmax' and 'gumbel_host'
    (near-ties counted, count tables exact, float sums within rtol 1e-5 /
    atol 1e-3) and 'gumbel' on its Philox noise."""
    import torch
    fk = port['fk']
    spec, py, shareds, values, labels, _ = problem
    B, C = REF_BLOCK, spec.capacity
    out = {}
    m = tile_inputs(port, spec, py, shareds, values, labels, B)
    noise = host_noise(port, B, C, 11)
    v = m['lay'].nich_vals
    cols = spec.blocks[0].cols

    # K1: nich2's product-form coefficients
    st = m['state']
    coeffs = fk.nich_coeffs_v2(shareds[0], st.groups[0]).contiguous()
    case = k1_case(port, v, m['cl_scores'], coeffs)
    modes = {mode: compare_mode(port, case, mode, noise.get(mode))
             for mode in REF_DET_MODES}

    def k1_draws(mode, nz, seed):
        return case.launch(mode, nz, seed)[0]
    philox = philox_exact(port, 'K1 C=%d' % C, k1_draws,
                          lambda fast: case.scores(), B, C, fast_modes=False)
    # rows whose draw is a slot of the upper Philox words
    philox['rows_drawn_high'] = int(
        (k1_draws('gumbel', None, 21) >= PHILOX_HIGH_SLOT).sum())
    bd = bounds(port, (v, m['cl_scores'], coeffs,
                       torch.empty(B, dtype=torch.int32),
                       torch.empty(C, 3 * cols)),
                gumbel_ops_per_cell((cols,), (), 0), B, C)
    out['K1'] = reference_kernel(port, case.launch, case.plain, modes,
                                 philox, bd, B, C)
    del case, coeffs

    # K4: the v1 record of the same rows and state
    coeffs = fk.nich_coeffs(shareds[0], st.groups[0]).contiguous()
    case = v1_case(port, 'K4', v, None, m['cl_scores'], coeffs, None)
    modes = {mode: compare_mode(port, case, mode, noise.get(mode))
             for mode in REF_DET_MODES}
    philox = v1_philox_exact(port, case)
    philox['rows_drawn_high'] = int(
        (case.launch('gumbel', None, 21)[0] >= PHILOX_HIGH_SLOT).sum())
    out['K4'] = reference_kernel(
        port, case.launch, case.plain, modes, philox,
        v1_bounds(port, (v, m['cl_scores'], coeffs), cols, 0, B, C), B, C)
    del case, coeffs

    # K3: the 2 x 4 mesh's four slot shards, each against its twin, reduced
    # against the whole slot axis; the last shard timed, its Philox checked
    n_comp = MESH_2D[1]
    cuts = tuple(range(0, C + 1, C // n_comp))
    pair_modes, best_err = check_pair_shards(port, m, cuts,
                                             noise['gumbel_host'], None)
    a, b = cuts[-2], cuts[-1]
    s_args, s_kwargs = slot_slice(m, a, b)
    s_kwargs.pop('noise')

    def k3(mode, nz, seed):
        return fk.fused_score_sample_pair(seed, *s_args, sampling=mode,
                                          noise=nz, **s_kwargs)

    def k3_plain(mode, nz, seed):
        return fk.fused_score_sample_pair_plain(seed, *s_args, sampling=mode,
                                                noise=nz, **s_kwargs)

    def k3_scores(fast):
        return fk._score_mixed(B, *s_args, s_kwargs['qvalues'],
                               s_kwargs['qcoeffs'], s_kwargs['quad_groups'],
                               s_kwargs['table_vs'], torch.log)
    philox = philox_exact(port, 'K3 [%d, %d)' % (a, b),
                          lambda mode, nz, seed: k3(mode, nz, seed)[0],
                          k3_scores, B, b - a, slot_offset=a,
                          fast_modes=False)
    bd = bounds(port, (v,) + s_args[2:4] + (
        torch.empty(B, dtype=torch.int32), torch.empty(B)),
        gumbel_ops_per_cell(m['col_groups'], (), 0), B, b - a)
    out['K3'] = dict(reference_kernel(port, k3, k3_plain, pair_modes,
                                      philox, bd, B, b - a),
                     slot_offset=a, shards=list(cuts),
                     best_max_abs_err=best_err)
    del m, noise

    # K2 on the bb layout: one table column, no float feature
    dev = port['config'].default_device()
    for Cb in (SLOTS, REF_SLOTS):
        bb_spec, bb_py, bb_sh, bb_values, bb_labels, _ = reference_problem(
            port, 'bb', 1, Cb, (7, 8))
        mb = tile_inputs(port, bb_spec, bb_py, bb_sh, tuple(
            torch.as_tensor(x, device=dev) for x in bb_values),
            torch.as_tensor(bb_labels, device=dev), B)
        case = k2_case(port, mb)
        nz = host_noise(port, B, Cb, 13)
        modes = {mode: compare_mode(port, case, mode, nz.get(mode))
                 for mode in REF_DET_MODES}
        lay = mb['lay']
        philox = philox_exact(port, 'K2 bb C=%d' % Cb,
                              lambda mode, nz, seed: case.launch(
                                  mode, nz, seed)[0],
                              lambda fast: case.scores(), B, Cb,
                              fast_modes=False)
        bd = bounds(port, (lay.table_idx, mb['cl_scores'], mb['tables'],
                           torch.empty(B, dtype=torch.int32),
                           torch.empty(Cb, sum(lay.table_vs))),
                    gumbel_ops_per_cell((), (), len(lay.table_vs)), B, Cb)
        out['K2_bb_c%d' % Cb] = dict(
            reference_kernel(port, case.launch, case.plain, modes,
                             philox, bd, B, Cb),
            table_vs=list(lay.table_vs))
        del mb, case, nz, bb_values
    return out


def reference_path(port, what, one, n, wrapper, want):
    """n chained sweeps of one(state, assignments, generator) (None, None:
    from the start) on the graph path against the eager loop, bitwise
    (`sharded_graph_check`, after the key's first call, eager), `want`
    launches of `wrapper` in the graph run; then ms/sweep graph against
    eager in turns (`graph_eager_turns`)."""
    import torch

    def chain():
        gen = torch.Generator().manual_seed(7)
        st = an = None
        for _ in range(n):
            st, an = one(st, an, gen)
        return st, an
    one(None, None, torch.Generator().manual_seed(7))
    g, rep = sharded_graph_check(port, what, chain, wrapper, want, n, 0)
    rep['timing'] = graph_eager_turns(port, chain, n)
    rep['sweeps'] = n
    return g, rep


def reference_paths(port, problem):
    """The other single-device paths and the component-sharded sweep on
    nich2 at 8192 slots, from the generating labels: K4
    (gibbs.sweep_blocked_pallas), the plain gibbs.sweep_blocked, and
    sharding.sharded_sweep_2d_fused on the in-process 2 x 4 mesh (K3,
    2048 slots a shard), each graph against eager.  Returns (report, K4's
    and K3's launches in the graph runs)."""
    import torch
    fk, mx, gibbs, sharding = (port['fk'], port['mx'], port['gibbs'],
                               port['sharding'])
    spec, py, shareds, values, a0, n_true = problem
    C = spec.capacity
    tiles = ROWS // REF_BLOCK
    st0 = mx.state_from_assignments(spec, py, shareds, values, a0)
    out = {'seconds': {}}
    t0 = time.time()

    def v1(st, an, gen):
        return gibbs.sweep_blocked_pallas(
            spec, py, shareds, st0 if st is None else st, values,
            a0 if an is None else an, REF_BLOCK, generator=gen,
            sampling='gumbel')
    n = REF_PATH_SWEEPS['v1']
    g, out['v1'] = reference_path(port, 'sweep_blocked_pallas C=%d' % C, v1,
                                  n, fk.nich_score_sample, tiles * n)
    out['v1']['checks'] = check_sweep(port, spec, py, shareds, values, *g)
    k4 = out['v1']['launches_graph_run']
    del g
    gibbs.release_sweep_graphs()
    out['seconds']['v1'] = round(time.time() - t0, 2)

    def plain(st, an, gen):
        return gibbs.sweep_blocked(
            spec, py, shareds, st0 if st is None else st, values,
            a0 if an is None else an, REF_BLOCK, generator=gen)
    n = REF_PATH_SWEEPS['plain']
    torch.cuda.reset_peak_memory_stats()
    g, out['plain'] = reference_path(port, 'sweep_blocked C=%d' % C, plain,
                                     n, None, 0)
    out['plain']['peak_allocated_bytes'] = torch.cuda.max_memory_allocated()
    out['plain']['checks'] = check_sweep(port, spec, py, shareds, values, *g)
    del g
    gibbs.release_sweep_graphs()
    out['seconds']['plain'] = round(
        time.time() - t0 - sum(out['seconds'].values()), 2)

    # the generating clusters spread evenly over the component shards'
    # slot ranges, so that every shard has free slots
    n_row, n_comp = MESH_2D
    per = -(-n_true // n_comp)
    a2 = a0 + (a0 // per) * (C // n_comp - per)
    mesh2 = sharding.make_mesh_2d(n_row, n_comp)
    sts = sharding.shard_state_components(
        mx.state_from_assignments(spec, py, shareds, values, a2), mesh2)
    local = REF_BLOCK // n_row

    def fused_2d(st, an, gen):
        st, an = sharding.sharded_sweep_2d_fused(
            spec, py, shareds, list(sts if st is None else st), values,
            a2 if an is None else an, gen, mesh2, local, sampling='gumbel')
        return tuple(st), an
    n = REF_PATH_SWEEPS['fused_2d']
    per_sweep = ROWS // n_row // local * n_row * n_comp
    g, out['fused_2d'] = reference_path(
        port, 'sharded_sweep_2d_fused C=%d' % C, fused_2d, n,
        fk.fused_score_sample_pair, per_sweep * n)
    out['fused_2d'].update(
        mesh=list(MESH_2D), C_local=C // n_comp, local_block=local,
        slot_offsets=list(range(0, C, C // n_comp)),
        checks=check_sharded(
            port, spec, py, shareds, values,
            sharding.unshard_state_components(list(g[0]), mesh2), g[1],
            n_comp))
    k3 = out['fused_2d']['launches_graph_run']
    del g, sts
    gibbs.release_sweep_graphs()
    out['seconds']['fused_2d'] = round(
        time.time() - t0 - sum(out['seconds'].values()), 2)
    return out, k4, k3


def phase_reference_configs(port):
    """The JAX package's documented benchmark configurations through the
    port's normal entry points (REF_CONFIGS: bench_runner.py's nich2 at 50
    sweeps a step, at 8192 slots, its one-column nich and its bb model),
    one line each; then, at 8192 slots, the other single-device paths and
    the component-sharded sweep graph against eager, and K1, K2 (bb), K3
    and K4 against their twins.  Returns the launches of K1-K4 in the
    phase's graph runs."""
    import torch
    t0 = time.time()
    launches = {'K1': 0, 'K2': 0}
    seconds = {}
    for name, model, cols, C, steps, frac in REF_CONFIGS:
        line, prob, n = reference_run(port, name, model, cols, C, steps, frac)
        launches['K2' if model == 'bb' else 'K1'] += n
        if name == 'nich2_c8192':
            problem = prob
        seconds[name] = round(time.time() - t0 - sum(seconds.values()), 2)
        emit(dict(line, seconds=seconds[name]))
    del prob
    paths, launches['K4'], launches['K3'] = reference_paths(port, problem)
    seconds['paths_c8192'] = round(time.time() - t0 - sum(seconds.values()),
                                   2)
    kernels = reference_kernels(port, problem)
    seconds['kernels_c8192'] = round(
        time.time() - t0 - sum(seconds.values()), 2)
    del problem
    torch.cuda.empty_cache()
    emit({'phase': 'reference_configs', 'config': 'c8192',
          'slots': REF_SLOTS, 'rows': ROWS, 'block': REF_BLOCK,
          'paths': paths, 'kernels': kernels, 'launches': launches,
          'seconds': seconds,
          'phase_seconds': round(time.time() - t0, 2)})
    return launches, kernels


def timed(fn):
    """(result, milliseconds) of fn() on the host clock, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.time() - t0)


def check_move(port, spec, st0, st1, a0, a1, accepted, what):
    """A refused move returns its inputs.  An accepted one moves rows of
    one slot s to one other slot t: all of them (a merge) or some of them
    into a slot that was empty (a split).  The two slots' counts and
    additive stats sum to what they summed to before (rtol 1e-5 / atol
    1e-3), and every other slot keeps its own.  Returns 'merge', 'split'
    or None (refused)."""
    import torch
    if not accepted:
        if not (st1 is st0 and torch.equal(a0, a1)):
            raise AssertionError('%s: a refused move changed the state'
                                 % what)
        return None
    moved = a0 != a1
    src, dst = torch.unique(a0[moved]), torch.unique(a1[moved])
    if src.numel() != 1 or dst.numel() != 1:
        raise AssertionError('%s: an accepted move took rows from slots %s '
                             'to slots %s' % (what, src.tolist(),
                                              dst.tolist()))
    s, t = int(src), int(dst)
    kind = 'merge' if int(st1.counts[s]) == 0 else 'split'
    if kind == 'split' and int(st0.counts[t]) != 0:
        raise AssertionError('%s: rows moved from slot %d into occupied slot '
                             '%d without emptying it' % (what, s, t))
    pair = torch.zeros(spec.capacity, dtype=torch.bool,
                       device=st0.counts.device)
    pair[[s, t]] = True
    ok = (torch.equal(st0.counts[~pair], st1.counts[~pair])
          and int(st0.counts[pair].sum()) == int(st1.counts[pair].sum()))
    for block, g0, g1 in zip(spec.blocks, st0.groups, st1.groups):
        for x0, x1 in zip(additive_leaves(block.module, g0),
                          additive_leaves(block.module, g1)):
            x0, x1 = x0.to(torch.float64), x1.to(torch.float64)
            ok = ok and torch.allclose(x0[~pair], x1[~pair], rtol=SUM_RTOL,
                                       atol=SUM_ATOL)
            ok = ok and torch.allclose(x0[pair].sum(0), x1[pair].sum(0),
                                       rtol=SUM_RTOL, atol=SUM_ATOL)
    if not ok:
        raise AssertionError('%s: the accepted %s of slots %d and %d does '
                             'not conserve their counts and stats'
                             % (what, kind, s, t))
    return kind


def moves_from_random_labels(port, spec, py, shareds, values, gen):
    """Split-merge moves of both kinds from uniform random labels, where
    every slot holds a sample of the same mixture and merges raise the
    posterior: the accepted path (the proposal's state rebuilt at full
    width) runs here, each move held by `check_move`.  The restricted
    moves stop at the first accepted one."""
    import torch
    mx = port['mx']
    from distributions_tpu_torch.ops import splitmerge
    dev = values[0].device
    ra = torch.randint(0, SLOTS, (ROWS,),
                       generator=torch.Generator().manual_seed(1)).to(
        device=dev, dtype=torch.int32)
    out = {}
    for name, move, tries in (
            ('split_merge_move', splitmerge.split_merge_move,
             SPLIT_MERGE_MOVES),
            ('split_merge_restricted', splitmerge.split_merge_restricted,
             RESTRICTED_TRIES)):
        st, a = mx.state_from_assignments(spec, py, shareds, values, ra), ra
        kinds, times = [], []
        for _ in range(tries):
            (st1, a1, acc), ms = timed(lambda: move(spec, py, shareds, st,
                                                    values, a, gen))
            times.append(ms)
            kinds.append(check_move(port, spec, st, st1, a, a1, acc, name))
            st, a = st1, a1
            if acc and name == 'split_merge_restricted':
                break
        check_state(port, spec, py, shareds, values, st, a,
                    name + ' (random labels)')
        accepted = len(kinds) - kinds.count(None)
        out[name + '_random_labels'] = {
            'moves': len(kinds), 'accepted': accepted,
            'merges': kinds.count('merge'), 'splits': kinds.count('split'),
            'ms_per_move_median': sorted(times)[len(times) // 2]}
        if not accepted:
            raise AssertionError('%s: no move accepted from random labels in '
                                 '%d; the accepted path did not run'
                                 % (name, len(kinds)))
    return out


def phase_moves(port, X, labels):
    """The other moves on the nich2 state at 1,048,576 rows x 1024 slots
    (Pitman-Yor, from the generating labels): one MH sweep, split-merge
    moves of both kinds, the sequential sweep at 4096 rows and 4 chains at
    65,536 rows; then split-merge moves from random labels, where they are
    accepted.  Every move must leave the state equal to
    state_from_assignments of its assignments."""
    import torch
    mx, gibbs = port['mx'], port['gibbs']
    from distributions_tpu_torch.ops import mh, splitmerge
    dev = port['config'].default_device()
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    values = (torch.as_tensor(X, device=dev),)
    an = torch.as_tensor(labels, device=dev)
    state = mx.state_from_assignments(spec, py, shareds, values, an)
    gen = torch.Generator().manual_seed(0)
    out = {'phase': 'moves', 'rows': ROWS, 'slots': SLOTS}

    (st, a), ms = timed(lambda: mh.sweep_mh(
        spec, py, shareds, state, values, an, MH_BLOCK, MH_STEPS, gen))
    changed = int((a != an).sum())
    out['sweep_mh'] = {'block': MH_BLOCK, 'mh_steps': MH_STEPS,
                       'ms_per_sweep': ms, 'rows_moved': changed,
                       'state_largest_differences': check_state(
                           port, spec, py, shareds, values, st, a,
                           'sweep_mh')[1]}

    st, a = state, an
    accepted, times = 0, []
    for _ in range(SPLIT_MERGE_MOVES):
        (st1, a1, acc), ms = timed(lambda: splitmerge.split_merge_move(
            spec, py, shareds, st, values, a, gen))
        check_move(port, spec, st, st1, a, a1, acc, 'split_merge_move')
        st, a = st1, a1
        accepted += acc
        times.append(ms)
    check_state(port, spec, py, shareds, values, st, a, 'split_merge_move')
    out['split_merge_move'] = {
        'moves': SPLIT_MERGE_MOVES, 'accepted': accepted,
        'acceptance_rate': accepted / SPLIT_MERGE_MOVES,
        'ms_per_move_median': sorted(times)[len(times) // 2]}

    accepted, times = 0, []
    for _ in range(RESTRICTED_MOVES):
        (st1, a1, acc), ms = timed(lambda: splitmerge.split_merge_restricted(
            spec, py, shareds, st, values, a, gen))
        check_move(port, spec, st, st1, a, a1, acc, 'split_merge_restricted')
        st, a = st1, a1
        accepted += acc
        times.append(ms)
    check_state(port, spec, py, shareds, values, st, a,
                'split_merge_restricted')
    # every move walks all the rows in play of two clusters at full width:
    # no depth was cut
    out['split_merge_restricted'] = {
        'moves': RESTRICTED_MOVES, 'rows': ROWS, 'depth_cut': None,
        'accepted': accepted, 'ms_per_move': times}

    n = SEQUENTIAL_ROWS
    small = (values[0][:n].contiguous(),)
    sa = an[:n].contiguous()
    sst = mx.state_from_assignments(spec, py, shareds, small, sa)
    (sst, sa), ms = timed(lambda: gibbs.sweep_sequential(
        spec, py, shareds, sst, small, sa, gen))
    check_state(port, spec, py, shareds, small, sst, sa, 'sweep_sequential')
    out['sweep_sequential'] = {'rows': n, 'slots': SLOTS,
                               'ms_per_sweep': ms, 'ms_per_row': ms / n}

    cv = (values[0][:CHAIN_ROWS].contiguous(),)
    A = torch.stack([an[:CHAIN_ROWS]] + [
        torch.randint(0, SLOTS // 2, (CHAIN_ROWS,), generator=gen).to(
            device=dev, dtype=torch.int32) for _ in range(CHAINS - 1)])
    states = gibbs.init_chains(spec, py, shareds, cv, A)
    gens = [torch.Generator().manual_seed(10 + c) for c in range(CHAINS)]
    (states, A), ms = timed(lambda: gibbs.sweep_blocked_chains(
        spec, py, shareds, states, cv, A, CHAIN_BLOCK, gens))
    for c in range(CHAINS):
        check_state(port, spec, py, shareds, cv, gibbs._chain_take(states, c),
                    A[c], 'sweep_blocked_chains')
    out['sweep_blocked_chains'] = {'chains': CHAINS, 'rows': CHAIN_ROWS,
                                   'block': CHAIN_BLOCK,
                                   'ms_per_sweep_of_all_chains': ms}
    out.update(moves_from_random_labels(port, spec, py, shareds, values,
                                        gen))
    emit(out)


# -- the gradient and particle backends, the sharded checkpoint -------------

# the suite's backends shapes (benchmarks/suite.py bench_backends)
BACKEND_ROWS = 262144
BACKEND_K = 64
BACKEND_PY = {'alpha': 5.0, 'd': 0.1}
BACKEND_SHARED = {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.1, 'nu': 1.}
# iterations at that shape: cut depths (PERF.md lists them)
HMC_ITERS = (100, 100, 16)          # warmup, samples, leapfrog steps
NUTS_ITERS = (30, 30, 5)            # warmup, samples, max_depth
ADVI_STEPS = 300
# the CPU tests' conjugate checks (tests/test_torch_backends.py 'short')
CONJ_ITERS = (200, 400, 8)
SMC_ROWS, SMC_PARTICLES, SMC_CAPACITY, SMC_EVERY = 2048, 256, 32, 64
EVIDENCE_PARTICLES = 4096
ANNEAL_TILE, ANNEAL_PASSES = 65536, 4
ORBAX_SWEEPS, ORBAX_EVERY = 4, 2


def logprob_f64(spec, py, shareds, X, params):
    """The mixture log-prob of inference/logprob.py for nich blocks,
    written again in float64 on the CPU (value, gradient leaves in
    `hmc._tree_leaves` order): the reference the card's f32 value and
    gradient are held to."""
    import math
    import torch
    sh = shareds[0]
    leaves = [params['blocks'][0]['log_sigmasq'], params['blocks'][0]['mu'],
              params['sticks']]
    leaves = [t.detach().cpu().double().requires_grad_(True)
              for t in leaves]
    log_sigmasq, mu, sticks = leaves
    alpha, d = float(py.alpha), float(py.d)
    log_v = torch.nn.functional.logsigmoid(sticks)
    log_1mv = torch.nn.functional.logsigmoid(-sticks)
    zero = sticks.new_zeros(1)
    logw = torch.cat([log_v, zero]) + torch.cat([zero, log_1mv.cumsum(0)])
    k = torch.arange(1, sticks.shape[0] + 1, dtype=torch.float64)
    a, b = 1.0 - d, alpha + k * d
    total = torch.sum(torch.lgamma(a + b) - math.lgamma(a) - torch.lgamma(b)
                      + (a - 1) * log_v + (b - 1) * log_1mv + log_v
                      + log_1mv)
    m0, kappa, s0, nu = (float(x) for x in sh)
    sigmasq = torch.exp(log_sigmasq)
    half = 0.5 * nu
    prior = (half * math.log(half * s0) - math.lgamma(half)
             - (1 + half) * log_sigmasq - half * s0 / sigmasq
             - 0.5 * (torch.log(2 * math.pi * sigmasq / kappa)
                      + (mu - m0) ** 2 * kappa / sigmasq) + log_sigmasq)
    total = total + prior.sum()
    x = torch.as_tensor(X).double()[:, None, :]
    ll = -0.5 * (torch.log(2 * math.pi * sigmasq) + (x - mu) ** 2 / sigmasq)
    total = total + torch.logsumexp(logw + ll.sum(-1), dim=1).sum()
    grads = torch.autograd.grad(total, leaves)
    return float(total.detach()), grads


def _mcse(x):
    """Monte Carlo standard error of a chain's mean by 20 batch means."""
    import numpy as np
    x = np.asarray(x, np.float64)
    means = x[:len(x) // 20 * 20].reshape(20, -1).mean(1)
    return means.std(ddof=1) / np.sqrt(20)


def _purity(labels, assign):
    import numpy as np
    assign = np.asarray(assign)
    return sum(np.bincount(labels[assign == k]).max()
               for k in np.unique(assign)) / len(labels)


def backends_small_checks(port):
    """The CPU tests' bb and nich conjugate checks (4 Monte Carlo standard
    errors) and the blob purity of HMC on the mixture, on the card's
    RNG."""
    import numpy as np
    import torch
    dev = port['config'].default_device()
    hmc, lp = port['hmc'], port['logprob']
    models, mx = port['models'], port['mx']
    bb, nich = models['bb'], models['nich']
    gen = torch.Generator().manual_seed
    warm, n, lf = CONJ_ITERS

    def single(module, shared, values):
        return lambda p: (module.param_log_prior(shared, p).sum()
                          + module.param_log_likelihood(shared, p,
                                                        values).sum())
    out = {}
    sh = bb.shared_from_dict({'alpha': 2.0, 'beta': 3.0})
    v = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1, 1, 1], dtype=torch.bool,
                     device=dev)
    samples, info = hmc.hmc(gen(0), single(bb, sh, v),
                            bb.param_init(gen(1), sh), num_samples=n,
                            num_warmup=warm, num_leapfrog=lf)
    p = torch.sigmoid(samples['logit_p']).cpu().numpy()
    out['bb'] = {'mean': float(p.mean()), 'exact': 10 / 15,
                 'mcse': float(_mcse(p)),
                 'accept_rate': float(info['accept_rate'])}
    ok = abs(p.mean() - 10 / 15) < 4 * _mcse(p) and \
        float(info['accept_rate']) > 0.5

    sh = nich.shared_from_dict({'mu': 0., 'kappa': 1., 'sigmasq': 1.,
                                'nu': 1.})
    v = torch.from_numpy((np.random.RandomState(0).randn(50) + 2.0).astype(
        np.float32)).to(dev)
    post = nich.plus_group(sh, nich.Group(
        count=torch.tensor(50, dtype=torch.int32, device=dev),
        mean=v.mean(), count_times_variance=((v - v.mean()) ** 2).sum()))
    samples, _ = hmc.hmc(gen(0), single(nich, sh, v),
                         nich.param_init(gen(1), sh), num_samples=n,
                         num_warmup=warm, num_leapfrog=lf)
    mu = samples['mu'].cpu().numpy()
    var = torch.exp(samples['log_sigmasq']).cpu().numpy()
    exact_var = float(post.nu * post.sigmasq / (post.nu - 2))
    out['nich'] = {'mu': float(mu.mean()), 'exact_mu': float(post.mu),
                   'mu_mcse': float(_mcse(mu)), 'sigmasq': float(var.mean()),
                   'exact_sigmasq': exact_var, 'sigmasq_mcse':
                   float(_mcse(var))}
    ok = ok and abs(mu.mean() - float(post.mu)) < 4 * _mcse(mu) and \
        abs(var.mean() - exact_var) < 4 * _mcse(var)

    rng = np.random.RandomState(0)
    spec = mx.make_spec([(nich, 2)], capacity=8)
    shb = (nich.shared_from_dict({'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0,
                                  'nu': 1.}),)
    labels = rng.randint(0, 2, 64)
    X = (np.array([[-2., -2.], [2., 2.]])[labels]
         + 0.2 * rng.randn(64, 2)).astype(np.float32)
    values = (torch.from_numpy(X).to(dev),)
    cl = port['cl'].PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    fn, init_fn = lp.make_mixture_logprob(spec, cl, shb, values, 4)
    samples, _ = hmc.hmc(gen(0), fn, init_fn(gen(5)), num_samples=50,
                         num_warmup=150, num_leapfrog=16)
    last = {'sticks': samples['sticks'][-1],
            'blocks': tuple({k: x[-1] for k, x in b.items()}
                            for b in samples['blocks'])}
    hard = lp.responsibilities(spec, cl, shb, last, values).argmax(1)
    out['blob_purity'] = float(_purity(labels, hard.cpu().numpy()))
    ok = ok and out['blob_purity'] > 0.9
    if not ok:
        raise AssertionError('backends: a conjugate or blob check failed: %s'
                             % out)
    return out


def smc_evidence_check(port):
    """SMC's log evidence of 5 rows against log sum exp(score_data) over
    the 52 canonical partitions (within 0.02), on the card."""
    import itertools
    import math
    import numpy as np
    import torch
    dev = port['config'].default_device()
    mx, nich = port['mx'], port['models']['nich']
    X = torch.from_numpy(np.random.RandomState(0).randn(5, 2).astype(
        np.float32)).to(dev)
    spec = mx.make_spec([(nich, 2)], capacity=8)
    sh = (nich.shared_from_dict({'mu': 0., 'kappa': 0.1, 'sigmasq': 1.,
                                 'nu': 1.}),)
    cl = port['cl'].PitmanYor.from_dict(PY)
    parts = set()
    for assign in itertools.product(range(5), repeat=5):
        seen = {}
        parts.add(tuple(seen.setdefault(a, len(seen)) for a in assign))
    scores = [float(mx.score_data(spec, cl, sh, mx.state_from_assignments(
        spec, cl, sh, (X,), torch.tensor(c, dtype=torch.int32,
                                          device=dev))))
              for c in sorted(parts)]
    top = max(scores)
    exact = top + math.log(sum(math.exp(x - top) for x in scores))
    _, _, _, log_ev = port['smc'].smc_init(
        spec, cl, sh, (X,), EVIDENCE_PARTICLES, 2,
        torch.Generator().manual_seed(0))
    out = {'partitions': len(parts), 'exact': exact,
           'smc': float(log_ev), 'particles': EVIDENCE_PARTICLES}
    if len(parts) != 52 or abs(float(log_ev) - exact) >= 0.02:
        raise AssertionError('backends: SMC evidence %s' % out)
    return out


def phase_backends(port, X):
    """The gradient and particle backends on the card: the logprob's value
    and gradient at the suite's shape against a float64 CPU evaluation;
    hmc, nuts and advi at that shape; the CPU tests' small checks on the
    card's RNG; smc_init at the suite's shape and the exact-evidence check;
    anneal at the flagship's width; the suite's backends section."""
    import numpy as np
    import torch
    dev = port['config'].default_device()
    mx, nich = port['mx'], port['nich']
    hmc, lp, vi = port['hmc'], port['logprob'], port['vi']
    out = {'phase': 'backends'}
    rng = np.random.RandomState(0)
    cl = port['cl'].PitmanYor.from_dict(BACKEND_PY)
    shareds = (nich.shared_from_dict(BACKEND_SHARED),)
    spec = mx.make_spec([(nich, FEATURES)], capacity=BACKEND_K)
    Xb = rng.randn(BACKEND_ROWS, FEATURES).astype(np.float32)
    values = (torch.from_numpy(Xb).to(dev),)
    fn, init_fn = lp.make_mixture_logprob(spec, cl, shareds, values,
                                          BACKEND_K)
    params = init_fn(torch.Generator().manual_seed(0))
    q0, unflat = hmc._flat(params)
    vg = hmc._value_and_grad_fn(fn, unflat)
    v, g = vg(q0)
    want_v, want_g = logprob_f64(spec, cl, shareds, Xb, params)
    got_g = [x.reshape(-1) for x in hmc._tree_leaves(unflat(g))]
    rel_v = abs(float(v) - want_v) / abs(want_v)
    rel_g = [float((a.cpu().double() - b.reshape(-1)).norm() / b.norm())
             for a, b in zip(got_g, want_g)]
    out['logprob'] = {'rows': BACKEND_ROWS, 'K': BACKEND_K,
                      'value_rel_err': rel_v, 'grad_rel_err': rel_g,
                      'ms_per_grad_eval': cuda_ms(lambda: vg(q0), 5),
                      'on_the_card': g.device.type == 'cuda'}
    if not (rel_v < 1e-4 and max(rel_g) < 1e-3
            and out['logprob']['on_the_card']):
        raise AssertionError('backends: logprob disagrees with float64: %s'
                             % out['logprob'])

    warm, n, lf = HMC_ITERS
    (samples, info), ms = timed(lambda: hmc.hmc(
        torch.Generator().manual_seed(1), fn, params, num_samples=n,
        num_warmup=warm, num_leapfrog=lf))
    finite = all(bool(torch.isfinite(x).all())
                 for x in hmc._tree_leaves(samples))
    out['hmc'] = {'warmup': warm, 'samples': n, 'leapfrog': lf,
                  'ms_per_iteration': ms / (warm + n),
                  'accept_rate': float(info['accept_rate']),
                  'step_size': float(info['step_size']), 'finite': finite}
    if not (finite and out['hmc']['accept_rate'] > 0.3):
        raise AssertionError('backends: hmc %s' % out['hmc'])
    warm, n, depth = NUTS_ITERS
    (samples, info), ms = timed(lambda: hmc.nuts(
        torch.Generator().manual_seed(2), fn, params, num_samples=n,
        num_warmup=warm, max_depth=depth))
    finite = all(bool(torch.isfinite(x).all())
                 for x in hmc._tree_leaves(samples))
    out['nuts'] = {'warmup': warm, 'samples': n, 'max_depth': depth,
                   'ms_per_iteration': ms / (warm + n),
                   'accept_rate': float(info['accept_rate']),
                   'step_size': float(info['step_size']), 'finite': finite}
    if not finite:
        raise AssertionError('backends: nuts %s' % out['nuts'])
    (var, info), ms = timed(lambda: vi.advi(
        torch.Generator().manual_seed(3), fn, params,
        num_steps=ADVI_STEPS))
    trace = info['elbo_trace']
    finite = bool(torch.isfinite(trace).all()) and all(
        bool(torch.isfinite(x).all()) for x in hmc._tree_leaves(var))
    out['advi'] = {'steps': ADVI_STEPS, 'ms_per_step': ms / ADVI_STEPS,
                   'elbo_first': float(trace[0]),
                   'elbo_last': float(trace[-1]), 'finite': finite}
    if not finite:
        raise AssertionError('backends: advi %s' % out['advi'])
    del fn, vg, values

    out['small_checks'] = backends_small_checks(port)

    smc = port['smc']
    shs = (nich.shared_from_dict(BACKEND_SHARED),)
    spec_s = mx.make_spec([(nich, FEATURES)], capacity=SMC_CAPACITY)
    Xs = torch.from_numpy(rng.randn(SMC_ROWS, FEATURES).astype(
        np.float32)).to(dev)
    (states, A, logw, log_ev), ms = timed(lambda: smc.smc_init(
        spec_s, cl, shs, (Xs,), SMC_PARTICLES, SMC_EVERY,
        torch.Generator().manual_seed(4)))
    sums_ok = bool((states.counts.sum(1) == SMC_ROWS).all())
    best, best_a = smc.best_particle(states, A, logw)
    check_state(port, spec_s, cl, shs, (Xs,), best, best_a,
                'smc best particle')
    out['smc'] = {'rows': SMC_ROWS, 'particles': SMC_PARTICLES,
                  'capacity': SMC_CAPACITY, 'ms': ms,
                  'ms_per_row': ms / SMC_ROWS,
                  'log_evidence': float(log_ev),
                  'counts_sum_to_rows': sums_ok,
                  'evidence_check': smc_evidence_check(port)}
    if not sums_ok:
        raise AssertionError('backends: smc %s' % out['smc'])
    del states, A

    py = port['cl'].PitmanYor.from_dict(PY)
    sha = (nich.shared_from_dict(SHARED),)
    spec_a = mx.make_spec([(nich, FEATURES)], capacity=SLOTS)
    Xa = (torch.from_numpy(X).to(dev),)
    (state, assign), ms = timed(lambda: port['annealing'].anneal(
        spec_a, py, sha, Xa, torch.Generator().manual_seed(5),
        passes=ANNEAL_PASSES, tile=ANNEAL_TILE))
    assigned = bool((assign >= 0).all())
    bincount_ok = bool(torch.equal(
        torch.bincount(assign.long(), minlength=SLOTS).to(torch.int32),
        state.counts))
    out['anneal'] = {'rows': X.shape[0], 'slots': SLOTS,
                     'tile': ANNEAL_TILE, 'passes': ANNEAL_PASSES,
                     'seconds': ms / 1e3, 'all_assigned': assigned,
                     'counts_equal_bincount': bincount_ok,
                     'nonempty': int((state.counts > 0).sum())}
    if not (assigned and bincount_ok):
        raise AssertionError('backends: anneal %s' % out['anneal'])
    emit(out)
    # the suite's section at its default shapes prints its own two lines
    # (one timed run after the warm-up: SMC's take 6 s each)
    port['suite'].bench_backends(reps=1)


# the facades phase (compat, the protobuf codec, the two examples)
FACADE_EVALS = 1000
FACADE_ATOL = {'gp': 2e-3, 'bnb': 5e-4}
FACADE_ROW_OPS = 200
DRIVER_ROWS = 2000
DRIVER_GROUPS = 64
DRIVER_BLOBS = 80
DRIVER_PY = {'alpha': 2.0, 'd': 0.1}
# light tails (nu 10), so that a row of another blob opens a group
DRIVER_SHARED = {'mu': 0., 'kappa': 0.01, 'sigmasq': 0.0025, 'nu': 10.}
FEATURE_GROUPS = 1024
FEATURE_VALUES = 256
DEMO_SAMPLES = 10000
DEMO_PASSES = 10
# the row-by-row strategies (1.3-2.8 ms a row on the card) at 2,000 points
DEMO_ROW_STRATEGIES = ('sequential', 'seq-gibbs', 'smc')
DEMO_ROW_SAMPLES = 2000
GMM_ROWS = 512
# the example's lengths cut for time (it takes ~170 s at its own on the
# card): HMC 100 + 100 iterations, NUTS 40 + 40, ADVI 300 steps
GMM_LENGTHS = {
    'gibbs_sweeps': 15, 'mh_sweeps': 40,
    'hmc': {'num_samples': 100, 'num_warmup': 100, 'num_leapfrog': 24},
    'nuts': {'num_samples': 40, 'num_warmup': 40, 'max_depth': 6},
    'advi': {'num_steps': 300},
}
# purity floors: the collapsed backends, the MH sweep, SMC and ADVI find
# the three blobs; HMC and NUTS report one chain's last draw, which may
# sit in a mode where two blobs share a component (purity ~2/3), so they
# are held only above what a labelling blind to the data reaches (~0.4)
GMM_PURITY = {'collapsed gibbs': 0.9, 'mh sweep': 0.9, 'smc': 0.9,
              'advi': 0.9, 'hmc': 0.6, 'nuts': 0.6}


def load_example(relpath, name):
    """An example script of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compat_on_the_card(port):
    """Each model's EXAMPLES[0] through the compat facade on the card and
    on the CPU: scores equal within 1e-5 (gp, bnb at their atol), the
    leaves on the card, ms of 1000 Sampler.evals and of an add_value +
    score_value row op."""
    import numpy as np
    import torch
    config, cm = port['config'], port['compat_models']
    out = {}
    for name in sorted(cm.MODULES):
        mod = cm.MODULES[name]
        ex = mod.EXAMPLES[0]
        sides = []
        for device in ('cpu', None):
            config.set_default_device(device)
            try:
                shared = mod.Shared.from_dict(ex['shared'])
                group = mod.Group.from_values(shared, ex['values'])
                scores = [group.score_value(shared, v)
                          for v in ex['values'][:3]]
                scores.append(group.score_data(shared))
            finally:
                config.set_default_device(None)
            sides.append((shared, group, scores))
        (_, _, want), (shared, group, got) = sides
        leaves = list(shared._data) + list(group._data)
        on_card = all(x.device.type == 'cuda' for x in leaves)
        err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
        bound = 1e-5 * max(1.0, float(np.max(np.abs(want))))
        atol = max(FACADE_ATOL.get(name, 0.0), bound)
        sampler = mod.Sampler()
        sampler.init(shared, group)
        draws, ms = timed(lambda: [sampler.eval(shared)
                                   for _ in range(FACADE_EVALS)])
        value = ex['values'][0]
        scratch = mod.Group.from_values(shared, ex['values'])

        def row_ops():
            for _ in range(FACADE_ROW_OPS):
                scratch.add_value(shared, value)
                scratch.score_value(shared, value)
        row_ops()
        _, row_ms = timed(row_ops)
        out[name] = {'on_the_card': on_card, 'max_abs_err': err,
                     'atol': atol, 'eval_ms': ms / FACADE_EVALS,
                     'draws': len(draws),
                     'ms_per_row_op': row_ms / FACADE_ROW_OPS}
        if not (on_card and err <= atol and len(draws) == FACADE_EVALS):
            raise AssertionError('facades: compat %s %s' % (name, out[name]))
    return out


def facade_driver_loop(port):
    """tests/test_compat.py's per-row loop (remove_value, score_value over
    all groups, a draw, add_value) through the facade on the card: a
    PitmanYor driver and two nich feature mixtures on 2000 rows of 80
    blobs, at most 64 groups (a full driver's empty group scores -inf);
    a seating pass, then one Gibbs pass, timed."""
    import numpy as np
    cm = port['compat_models']
    from distributions_tpu_torch.compat.clustering import PitmanYor
    from distributions_tpu_torch.compat.mixture import MixtureIdTracker
    rng = np.random.RandomState(0)
    centers = 2.0 * rng.randn(DRIVER_BLOBS, 2)
    X = centers[rng.randint(0, DRIVER_BLOBS, DRIVER_ROWS)] + 0.03 * rng.randn(
        DRIVER_ROWS, 2)
    cl = PitmanYor.from_dict(DRIVER_PY)
    feature = cm.nich.Shared.from_dict(DRIVER_SHARED)
    cmix = cl.Mixture()
    fmixes = [cm.nich.Mixture(), cm.nich.Mixture()]
    tracker = MixtureIdTracker()
    cmix.init(cl, [0])
    tracker.init(1)
    for fmix in fmixes:
        fmix.add_group(feature)
    assignments = np.zeros(DRIVER_ROWS, np.int64)

    def seat(i):
        scores = np.zeros(len(cmix), np.float32)
        cmix.score_value(cl, scores)
        for j, fmix in enumerate(fmixes):
            fmix.score_value(feature, float(X[i, j]), scores)
        if len(cmix) >= DRIVER_GROUPS:
            scores[np.asarray(cmix.counts) == 0] = -np.inf
        gid = int(np.argmax(scores + rng.gumbel(size=len(scores))))
        if cmix.add_value(cl, gid):
            tracker.add_group()
            for fmix in fmixes:
                fmix.add_group(feature)
        for j, fmix in enumerate(fmixes):
            fmix.add_value(feature, gid, float(X[i, j]))
        assignments[i] = tracker.packed_to_global(gid)

    def unseat(i):
        gid = tracker.global_to_packed(int(assignments[i]))
        removed = cmix.remove_value(cl, gid)
        for j, fmix in enumerate(fmixes):
            fmix.remove_value(feature, gid, float(X[i, j]))
            if removed:
                fmix.remove_group(feature, gid)
        if removed:
            tracker.remove_group(gid)

    _, seat_ms = timed(lambda: [seat(i) for i in range(DRIVER_ROWS)])

    def gibbs_pass():
        for i in range(DRIVER_ROWS):
            unseat(i)
            seat(i)
    _, pass_ms = timed(gibbs_pass)
    packed = np.asarray([tracker.global_to_packed(int(g))
                         for g in assignments])
    want = np.bincount(packed, minlength=len(cmix)).tolist()
    out = {'rows': DRIVER_ROWS, 'groups': len(cmix),
           'nonempty': int(sum(c > 0 for c in cmix.counts)),
           'counts_equal_bincount': cmix.counts == want,
           'sizes_agree': len(cmix) == len(tracker) == len(fmixes[0]),
           'seat_ms_per_row': seat_ms / DRIVER_ROWS,
           'gibbs_ms_per_row': pass_ms / DRIVER_ROWS}
    if not (out['counts_equal_bincount'] and out['sizes_agree']
            and len(cmix) <= DRIVER_GROUPS):
        raise AssertionError('facades: driver loop %s' % out)
    return out


def feature_mixture_scores(port):
    """FeatureMixture.score_value over 1024 nich groups on the card against
    the per-group scores of nich.score_value on the CPU, 256 values."""
    import numpy as np
    import torch
    cm, nich = port['compat_models'], port['nich']
    rng = np.random.RandomState(1)
    shared = cm.nich.Shared.from_dict(SHARED)
    mixture = cm.nich.Mixture()
    for k in range(FEATURE_GROUPS):
        mixture.append(cm.nich.Group.from_values(
            shared, rng.randn(1 + k % 4).tolist()))
    values = rng.randn(FEATURE_VALUES).tolist()
    accum = np.zeros((FEATURE_VALUES, FEATURE_GROUPS), np.float32)

    def score_all():
        for v, row in zip(values, accum):
            mixture.score_value(shared, v, row)
    score_all()
    accum[:] = 0
    _, ms = timed(score_all)
    cpu_shared = type(shared._data)(*(x.cpu() for x in shared._data))
    cpu_groups = type(mixture._stack)(*(x.cpu() for x in mixture._stack))
    want = np.stack([nich.score_value(cpu_shared, cpu_groups, v).numpy()
                     for v in values])
    err = float(np.max(np.abs(accum - want)))
    out = {'groups': FEATURE_GROUPS, 'values': FEATURE_VALUES,
           'max_abs_err': err, 'ms_per_call': ms / FEATURE_VALUES,
           'on_the_card': mixture._stack[0].device.type == 'cuda'}
    if not (err < 1e-4 and out['on_the_card']):
        raise AssertionError('facades: FeatureMixture %s' % out)
    return out


def protobuf_on_the_card(port):
    """Every model's Shared and Group built on the card (EXAMPLES[0]) and
    the clustering priors: bytes equal to those of the same objects on the
    CPU, and loaded back onto the card equal."""
    import torch
    pb, models, cl = port['protobuf'], port['models'], port['cl']
    out = {}
    for name in sorted(models):
        mod = models[name]
        ex = mod.EXAMPLES[0]
        shared = mod.shared_from_dict(ex['shared'])
        if name == 'dpd':
            gen = torch.Generator().manual_seed(0)
            for v in ex['values']:
                shared = mod.shared_add_value(gen, shared, v)
        group = mod.group_init(shared)
        for v in ex['values']:
            group = mod.add_value(shared, group, v)
        cpu_shared = type(shared)(*(x.cpu() for x in shared))
        cpu_group = type(group)(*(x.cpu() for x in group))
        t0 = time.time()
        sbytes = pb.shared_dump(name, shared).SerializeToString()
        gbytes = pb.group_dump(name, group, shared=shared).SerializeToString()
        dump_us = 1e6 * (time.time() - t0)
        same = (sbytes == pb.shared_dump(name, cpu_shared).SerializeToString()
                and gbytes == pb.group_dump(
                    name, cpu_group, shared=cpu_shared).SerializeToString())
        t0 = time.time()
        shared2 = pb.shared_load(name, pb.MESSAGES[name].Shared.FromString(
            sbytes))
        group2 = pb.group_load(name, pb.MESSAGES[name].Group.FromString(
            gbytes), shared=shared2)
        load_us = 1e6 * (time.time() - t0)
        loaded = all(a.device.type == 'cuda' and torch.equal(a, b)
                     for a, b in zip(list(shared2) + list(group2),
                                     list(shared) + list(group)))
        out[name] = {'bytes': len(sbytes) + len(gbytes),
                     'bytes_equal_cpu': same, 'loads_equal': loaded,
                     'dump_us': dump_us, 'load_us': load_us}
        if not (same and loaded):
            raise AssertionError('facades: protobuf %s %s'
                                 % (name, out[name]))
    for model in (cl.PitmanYor.from_dict(DRIVER_PY),
                  cl.LowEntropy.from_dict({'dataset_size': 1000})):
        data = pb.clustering_dump(model).SerializeToString()
        cpu = type(model)(*(x.cpu() for x in model))
        back = pb.clustering_load(pb.Clustering.FromString(data))
        ok = (data == pb.clustering_dump(cpu).SerializeToString()
              and type(back) is type(model)
              and back.to_dict() == model.to_dict()
              and all(x.device.type == 'cuda' for x in back))
        out[type(model).__name__] = {'bytes': len(data), 'ok': ok}
        if not ok:
            raise AssertionError('facades: protobuf %s' % type(model))
    return out


def mixture_example(port):
    """examples/mixture/main_torch.py at its own scale: the tracked 10,000
    points (the first 2,000 for the row-by-row strategies), capacity 768,
    10 passes, all five strategies on the card, images into a temporary
    directory."""
    import tempfile
    import numpy as np
    import torch
    demo = load_example(os.path.join('examples', 'mixture', 'main_torch.py'),
                        'mixture_main_torch')
    generator = torch.Generator().manual_seed(0)
    image, X = demo.create_dataset(generator, DEMO_SAMPLES)
    model = demo.ImageModel()
    out = {'samples': DEMO_SAMPLES, 'passes': DEMO_PASSES,
           'capacity': model.spec.capacity}
    with tempfile.TemporaryDirectory() as tmp:
        for name in demo.STRATEGIES:
            rows = (DEMO_ROW_SAMPLES if name in DEMO_ROW_STRATEGIES
                    else DEMO_SAMPLES)
            state, assignments, seconds, img = demo.run_strategy(
                name, model, X[:rows], generator, image.shape, DEMO_PASSES,
                tmp)
            counts = state.counts
            row = {'rows': rows, 'seconds': seconds,
                   'components': int((counts > 0).sum()),
                   'count_sum': int(counts.sum()),
                   'on_the_card': counts.device.type == 'cuda',
                   'image': [list(img.shape), str(img.dtype)]}
            out[name] = row
            if not (row['count_sum'] >= rows and row['on_the_card']
                    and img.shape == (64, 64) and img.dtype == np.uint8):
                raise AssertionError('facades: mixture example %s %s'
                                     % (name, row))
    return out


def gmm_example(port):
    """examples/gmm_backends_torch.py at --rows 512 on the card, its
    chains cut to GMM_LENGTHS; every backend's purity above its floor in
    GMM_PURITY."""
    gmm = load_example(os.path.join('examples', 'gmm_backends_torch.py'),
                       'gmm_backends_torch')
    results = gmm.run(GMM_ROWS, GMM_LENGTHS)
    out = {name: {'seconds': s, 'purity': p}
           for name, (s, p) in results.items()}
    out['lengths'] = GMM_LENGTHS
    if sorted(results) != sorted(GMM_PURITY) or not all(
            GMM_PURITY[name] < p <= 1.0 for name, (_, p) in results.items()):
        raise AssertionError('facades: gmm example %s' % out)
    return out


def phase_facades(port):
    """The class facade, the codec and the two examples on the card: the
    rest of the JAX package's public surface, driven as a user would."""
    t0 = time.time()
    out = {'phase': 'facades'}
    out['compat'] = compat_on_the_card(port)
    out['driver_loop'] = facade_driver_loop(port)
    out['feature_mixture'] = feature_mixture_scores(port)
    out['protobuf'] = protobuf_on_the_card(port)
    out['mixture_example'] = mixture_example(port)
    out['gmm_example'] = gmm_example(port)
    out['seconds'] = time.time() - t0
    emit(out)


def phase_main_orbax(port, X, labels):
    """run_gibbs(use_pallas=True, checkpoint_format='orbax') on the
    flagship nich2 problem: an interrupted and resumed run against the
    uninterrupted one, bitwise; a crash left in the middle of the swap
    (only a complete .tmp-orbax) recovered and resumed from; the run fed
    RowSharded values on a 2-shard in-process row mesh against the run fed
    the full values on that mesh, bitwise; save and load seconds and the
    directory's bytes."""
    import shutil
    import tempfile
    import torch
    dev = port['config'].default_device()
    runner, mx, co = port['runner'], port['mx'], port['checkpoint_orbax']
    sharding, fk = port['sharding'], port['fk']
    spec = mx.make_spec([(port['nich'], FEATURES)], capacity=SLOTS)
    shareds = (port['nich'].shared_from_dict(SHARED),)
    py = port['cl'].PitmanYor.from_dict(PY)
    values = (torch.from_numpy(X).to(dev),)
    out = {'phase': 'main_orbax', 'rows': X.shape[0], 'slots': SLOTS,
           'sweeps': ORBAX_SWEEPS, 'checkpoint_every': ORBAX_EVERY}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')

    def equal(a, b):
        st_a, an_a = a[:2]
        st_b, an_b = b[:2]
        if isinstance(an_a, sharding.RowSharded):
            an_a = torch.cat(an_a.shards)
        if isinstance(an_b, sharding.RowSharded):
            an_b = torch.cat(an_b.shards)
        return bool(torch.equal(an_a, an_b)
                    and torch.equal(st_a.counts, st_b.counts)
                    and all(torch.equal(x, y) for x, y in
                            zip(st_a.groups[0], st_b.groups[0])))
    try:
        common = dict(block=BLOCK, use_pallas=True, sampling='gumbel',
                      grow_headroom=0.0, checkpoint_every=ORBAX_EVERY,
                      sweeps_per_step=ORBAX_EVERY, checkpoint_format='orbax',
                      initial_assignments=labels)

        def run(passes, name, seed, resume, vals=values, **kw):
            return runner.run_gibbs(
                spec, py, shareds, vals, torch.Generator().manual_seed(seed),
                passes, checkpoint_path=os.path.join(tmp, name),
                resume=resume, **dict(common, **kw))
        before = fk.fused_score_sample_stats.launches
        full = run(ORBAX_SWEEPS, 'full', 5, False)
        out['launches_k1'] = fk.fused_score_sample_stats.launches - before
        run(ORBAX_EVERY, 'crash', 5, False)
        resumed = run(ORBAX_SWEEPS, 'crash', 999, True)
        run(ORBAX_EVERY, 'swap', 5, False)
        path = os.path.join(tmp, 'swap')
        os.rename(path, path + '.tmp-orbax')
        recovered = co.recover(path)
        swapped = run(ORBAX_SWEEPS, 'swap', 999, True)
        mesh = sharding.make_mesh(2)
        rows = (sharding.RowSharded(list(values[0].chunk(2)), X.shape[0],
                                    mesh),)
        on_full = run(ORBAX_SWEEPS, 'mesh_full', 6, False, mesh=mesh)
        on_rows = run(ORBAX_SWEEPS, 'mesh_rows', 6, False, vals=rows,
                      mesh=mesh)
        checks = {
            'resume_bitwise': equal(full, resumed),
            'sweeps_continuous': [r['sweep'] for r in resumed[2].rows]
            == [r['sweep'] for r in full[2].rows],
            'recovered': recovered and not os.path.exists(
                path + '.tmp-orbax'),
            'swap_resume_bitwise': equal(full, swapped),
            'row_sharded_returns_row_sharded': isinstance(
                on_rows[1], sharding.RowSharded),
            'row_sharded_equals_full': equal(on_full, on_rows),
            'on_the_card': full[1].device.type == 'cuda',
            'k1_launched': out['launches_k1'] > 0,
        }
        out.update(checks)
        if not all(checks.values()):
            raise AssertionError('main_orbax: %s' % checks)
        st, an, log = full
        path = os.path.join(tmp, 'timed')
        gen = torch.Generator().manual_seed(1)
        torch.cuda.synchronize()
        t0 = time.time()
        co.save_sharded(path, st, assignments=an, generator=gen,
                        sweep=ORBAX_SWEEPS, logger_rows=log.rows,
                        shareds=shareds, cl_model=py, spec=spec)
        t1 = time.time()
        loaded = co.load_sharded(path, spec, shareds, extended=True)
        torch.cuda.synchronize()
        t2 = time.time()
        if not (torch.equal(loaded.assignments, an)
                and torch.equal(loaded.state.counts, st.counts)):
            raise AssertionError('main_orbax: the checkpoint does not load '
                                 'back')
        out['checkpoint'] = {
            'save_seconds': t1 - t0, 'load_seconds': t2 - t1,
            'directory_bytes': sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)


def small_run(port, spec_of, values_np, labels, device):
    """3 'argmax' sweeps of a small problem on `device` (None: the
    default, the card)."""
    import torch
    kwargs = {} if device is None else {'device': device}
    spec, py, shareds = spec_of(kwargs)
    state, a, log = port['runner'].run_gibbs(
        spec, py, shareds, values_np, torch.Generator().manual_seed(0), 3,
        block=1024, use_pallas=True, sampling='argmax',
        initial_assignments=labels, **kwargs)
    return a, log.rows[-1]['score_data']


def phase_small_reference(port, phase, spec_of, values_np, labels, wrapper):
    """The kernel path on the card against the twin path on the CPU, on a
    small well-separated input under 'argmax': equal draws expected."""
    import torch
    before = wrapper.launches
    a_card, s_card = small_run(port, spec_of, values_np, labels, None)
    if a_card.device.type != 'cuda' or wrapper.launches != before + 12:
        raise AssertionError('%s did not run on the card through its kernel'
                             % phase)
    a_cpu, s_cpu = small_run(port, spec_of, values_np, labels, 'cpu')
    equal = bool(torch.equal(a_card.cpu(), a_cpu))
    rel = abs(s_card - s_cpu) / abs(s_cpu)
    emit({'phase': phase, 'argmax_draws_equal': equal,
          'score_rel_diff': rel})
    if not (equal and rel < 1e-4):
        raise AssertionError('%s: kernel path disagrees with the CPU twin '
                             'path' % phase)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke.py: no CUDA device; this script runs only on a '
              'GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from distributions_tpu_torch import (clustering, config, diagnostics,
                                         mixture, random, testing)
    from distributions_tpu_torch.benchmarks import (bench_runner,
                                                    kernel_phases, roofline,
                                                    suite)
    from distributions_tpu_torch.inference import (annealing, hmc, hypers,
                                                   logprob, runner, smc, vi)
    from distributions_tpu_torch.compat import models as compat_models
    from distributions_tpu_torch.io import (checkpoint, checkpoint_orbax,
                                            protobuf)
    from distributions_tpu_torch.models import MODULES, base, nich
    from distributions_tpu_torch.ops import bench_kernels, fused_kernels, gibbs
    from distributions_tpu_torch.parallel import distributed, sharding
    port = {'cl': clustering, 'config': config, 'diagnostics': diagnostics,
            'mx': mixture,
            'random': random, 'testing': testing, 'runner': runner,
            'base': base, 'nich': nich, 'models': MODULES,
            'fk': fused_kernels, 'gibbs': gibbs, 'checkpoint': checkpoint,
            'sharding': sharding, 'distributed': distributed,
            'bk': bench_kernels, 'roofline': roofline, 'suite': suite,
            'kernel_phases': kernel_phases, 'hypers': hypers,
            'hmc': hmc, 'logprob': logprob, 'vi': vi, 'smc': smc,
            'annealing': annealing, 'checkpoint_orbax': checkpoint_orbax,
            'compat_models': compat_models, 'protobuf': protobuf,
            'bench_runner': bench_runner}
    fk = fused_kernels
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('TF32 matmuls must stay off on this path')
    card = smi()
    emit({'phase': 'device', 'nvidia_smi': card,
          'default_device': str(config.default_device()),
          'torch': torch.__version__, 'cuda': torch.version.cuda})
    phase_build(fk)
    # the measurement kernels and the card's rates first: the measured
    # bounds of every kernel below divide by them
    b4 = phase_kernel_b4(port)
    b2 = phase_kernel_b2(port)
    b3 = phase_kernel_b3(port)
    launches = phase_roofline(port)
    b2['launches'], b3['launches'], b4['launches'] = (
        launches['B2'], launches['B3'], launches['B4'])
    b5_launches = phase_kernel_phases(port)
    X, labels = flagship_data()
    b5 = phase_kernel_b5(port, X, labels)
    b5['launches'] = b5_launches
    b1 = phase_kernel_b1(port)
    b1['launches'] = phase_suite(port)
    k1 = phase_kernel(port, X, labels)
    k2 = phase_kernel_k2(port)
    stages = phase_kernel_stats(port, X, labels)
    k3 = phase_kernel_k3(port)
    k4 = phase_kernel_k4(port, X, labels)
    k5 = phase_kernel_k5(port)

    Xs, ls = testing.nich_problem(4096, seed=3)

    def nich_spec(kwargs):
        return (mixture.make_spec([(nich, 2)], capacity=128),
                clustering.PitmanYor.from_dict(testing.PY, **kwargs),
                (nich.shared_from_dict(testing.NICH_SHARED, **kwargs),))
    phase_small_reference(port, 'small_reference', nich_spec, (Xs,), ls,
                          fk.fused_score_sample_stats)
    small = testing.mixed_problem(4096, 128, seed=3, kind='niw3_nich_bb')
    phase_small_reference(
        port, 'small_reference_mixed',
        lambda kwargs: testing.build_problem(
            small, MODULES, mixture.make_spec, clustering.PitmanYor.from_dict,
            **kwargs),
        small['values'], small['labels'], fk.fused_mixed_score_sample_stats)

    k1['launches'] = phase_main(port, X, labels)
    k4['launches'], k5['launches'] = phase_paths_v1(port, X, labels)
    phase_main_resume(port, X, labels)
    phase_init(port, X)
    phase_main_mesh(port, X, labels)
    phase_process_group(port, X, labels)
    mixed = testing.mixed_problem(ROWS, SLOTS, seed=0, kind='niw2mix',
                                  n_clusters=TRUE_CLUSTERS)
    k2['launches'] = phase_main_mixed(port, mixed)
    # the stat stage runs inside every launch of K1 and K2 (run_main
    # checks the profiler's count of it in the last step)
    stages['K1']['launches'] = k1['launches']
    stages['K2']['launches'] = k2['launches']
    phase_graphs(port, X, labels, mixed)
    phase_plain_graphs(port, X, labels, mixed)
    k3['launches'] = phase_sharded(port, X, labels, mixed)
    k1['launches_main_le'], k2['launches_main_le'] = phase_main_le(
        port, X, labels, mixed)
    del mixed
    ref_launches, ref_kernels = phase_reference_configs(port)
    for k, name in ((k1, 'K1'), (k2, 'K2'), (k3, 'K3'), (k4, 'K4')):
        k['launches_reference_configs'] = ref_launches[name]
    for k, name in ((k1, 'K1'), (k3, 'K3'), (k4, 'K4'),
                    (k2, 'K2_bb_c%d' % REF_SLOTS)):
        k['ms_c8192'] = ref_kernels[name]['ms']
    phase_main_hypers(port, X, labels)
    phase_moves(port, X, labels)
    phase_main_orbax(port, X, labels)
    phase_backends(port, X)
    del X
    phase_samplers(port)
    phase_facades(port)
    pk = 'distributions_tpu/ops/pallas_kernels.py:%d'
    split = 'the slot-split walk (csrc/fused_split.cuh)'
    split_v1 = split + ', v1 form'
    stat_design = ('rows staged in shared memory, the walk split across '
                   'warps, partials and a fixed-order reduce that follow '
                   'the rows')
    kernels = []
    for name, source, replaces, k, design in (
            ('fused_v2 (K1)', 'fused_v2.cu', pk % 535, k1, split),
            ('fused_v3 (K2)', 'fused_v3.cu', pk % 749, k2, split),
            ('fused_v2 stat stage (K1)', 'fused_stats.cuh', pk % 574,
             stages['K1'], stat_design),
            ('fused_v3 stat stage (K2)', 'fused_stats.cuh', pk % 821,
             stages['K2'], stat_design),
            ('fused_v3_pair (K3)', 'fused_v3.cu', pk % 1061, k3, split),
            ('score_sample_v1_nich (K4)', 'score_sample_v1.cu', pk % 137, k4,
             split_v1),
            ('score_sample_v1_mixed (K5)', 'score_sample_v1.cu', pk % 247,
             k5, split_v1),
            ('sampler_gumbel (B1)', 'sampler_bench.cu',
             'benchmarks/suite.py:481', b1, None),
            ('roofline_chain (B2)', 'roofline.cu',
             'benchmarks/roofline.py:79', b2, None),
            ('roofline_mma (B3)', 'roofline.cu',
             'benchmarks/roofline.py:124', b3,
             'persistent wgmma on TMA tiles, one cooperative launch'),
            ('roofline_copy (B4)', 'roofline.cu',
             'benchmarks/roofline.py:166', b4, 'a TMA bulk-copy ring'),
            ('fused_v2 phases (B5)', 'fused_v2.cu',
             'profile_kernel_phases.py:64', b5, split)):
        if not k['launches'] > 0:
            raise AssertionError('%s was not launched on its main path'
                                 % name)
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'distributions_tpu_torch/csrc/' + source,
            'replaces': replaces,
            'launches': k['launches'], 'max_abs_err': k['max_abs_err'],
            'ms': k['ms'], 'plain_ms': k['plain_ms'],
            'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'],
            'measured_bound_ms': k['measured_bound_ms'],
            'measured_bound_by': k['measured_bound_by'],
            # K1 and K2 also carry the LowEntropy runs of main_le; K1-K5
            # their time with the seed passed by value (`ms` is the
            # main path's launch, the seed read from device memory)
            'launches_main_le': k.get('launches_main_le'),
            # K1-K4 in the JAX package's documented configurations
            # (reference_configs), and their ms at 8192 slots (K2: bb)
            'launches_reference_configs': k.get(
                'launches_reference_configs'),
            'ms_c8192': k.get('ms_c8192'),
            'ms_by_value': k.get('ms_by_value'),
            # no single PyTorch call computes score + draw (+ sums), a
            # dependent chain or a resident sampler; B3, B4 and the stat
            # stages (index_add_) have one
            'library_ms': k.get('library_ms'),
            'redesigned': design})
    emit({'kernels': kernels})
    print('nvidia-smi: %s' % card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
