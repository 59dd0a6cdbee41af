#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card (an H100) end to end.

    python3 chip_smoke.py            # from the repository root

Phases, one flushed line each with the elapsed seconds:
  1. build: one nvcc call compiles every kernel source (csrc/*.cu);
  2. kernel checks: every kernel instantiation against its plain PyTorch
     version on the card, at the full shared-set shapes (128 instances of
     4-SAT, n=100, alpha=9: E=524,288 padded / 460,800 real edges,
     V=16,384). Flags and counts must match exactly, float sums to rtol
     1e-5 / atol 1e-6 (the plain version sums in another order); each is
     then timed (CUDA events) beside its plain version and its bound;
     WalkSAT (kernel 3: walksat_walk, one launch for a whole walk) bit for
     bit against its plain version for 1, 8 and 25 blocks of 8
     iterations, eps -1 and 0.5, from a problem with some variables and
     clauses inactive and from a random fill (every instance unsat), on
     the shared set, a compacted batch (8 instances), the hub (one
     variable in 63,488 clauses: its edges in global memory) and a large
     banded instance (30,000 variables: its variables too), the one-block
     and 25-block forms then timed three ways on each, their bounds
     counting the operations of each instance's iterations up to its
     stop (every clause in the first, the flipped variable's after);
     The [E, d] segment sum and gather of the neural modules (kernels 6
     and 7) are checked at the np-nd-np shapes (d = 50): the sum to rtol
     1e-5 / atol 1e-5 (the plain index_add_ on the card sums in atomic
     order), the gather and the gather-minus-self bit for bit with i32
     and i64 ids; and on bf16 rows (compute_dtype="bfloat16") on the
     shared set and a compacted batch, in the aggregators' forms: bf16
     rows into f32 sums over both CSRs to rtol 1e-5 / atol 1e-5, f32 sums
     minus bf16 rows bit for bit with i32 and i64 ids, timed beside
     index_add_ and index_select on bf16; kernel 6 on f32 and bf16 rows
     over both CSRs of the shared set, a compacted batch and the hub
     (its 63,488-edge variable cut into pieces), with the batch's
     largest degree as the path passes it: bit for bit against its
     order emulated in PyTorch (ops/reduce2d.py walk_order_sum_2d), the
     same bits twice and within rtol 1e-5 / atol 1e-5 of the float64
     index_add_, the hub's forms timed beside index_add_;
     The multi-column segment sum (kernel 4; C = 1 and 2 over the var CSR,
     C = 1 over the clause CSR), the same kernel on a ragged batch of
     mixed clause widths (kernel 5's function) and over sorted ids
     (kernel 8's function), exact on integer columns and to rtol 1e-5 /
     atol 1e-6 on floats, timed beside index_add_ and kernel 6. Kernels
     4, 5, 8, kernel 1's var side and kernel 2's var phase run the group
     walk (csrc/common.cuh): each gives the same bits on two calls, and
     kernels 4, 5, 8 and kernel 2's variable sums the bits of the walk's
     order emulated in PyTorch (ops/reduce.py walk_order_sum, over the
     plain f3 terms for kernel 2). Kernels 1, 2, 4, 5, 6, 7, 8 and 9 and
     their PyTorch calls are timed three ways (utils/bench_kernels.py
     timed): ms / call with CUDA events, host us / call with perf_counter
     and no synchronize, device us / call from the profiler; and kernels
     1, 2, 4, 7, 8 and 9 again at a compacted shape (the 8 instances of a
     32,768-edge bucket), kernels 1, 2 and 4 at high degree (a var CSR
     with one 63,488-edge node; kernel 8 over the shared set's clause ids
     with the padding's 63,488-edge last run), whose float sums are held
     against the plain version in float64; the one-launch SP sweep
     (kernel 9) for pi = 0 and 0.01 and in its log-input form (login=True,
     p-nd-np's) against its plain version (rtol 1e-5 / atol 1e-6) and bit
     for bit against the two launches it replaces (`sp_chain` or
     `sp_chain_login`, then `sp_pass_c`), on the shared set and the
     compacted batch, and on both replicated twice;
     kernels 1 and 2 on the replicated layout: every fused and chained
     functor on the shared set and the compacted batch replicated twice
     (replica 0's padding edges, clauses, variables and rows inside the
     prefix the kernels treat as real), held as above on every output
     row, the SP passes' mask 1 on padding edges as the solver's is;
     the verification with the freeze and the next masks in one launch
     (kernel 10) exactly against its plain version and the split path it
     replaces (cnf_chain, the freeze, em_ae), on the shared set's graphs
     with planted signs, some variables and clauses inactive, some
     instances stopped and a prediction that solves half of them, timed
     beside both; the replicated walk (kernel 3 with R = 2: a launch a
     block, a done flag on the card) bit for bit against the plain walk
     with its replica stop on the shared set and a compacted batch,
     replicated, from a random fill and from a problem where every
     instance gets a solved replica before the last block, timed per call
     and per block; np-d-np's decimator pass (`smax`, kernel 1) with the
     other functors; the sweep folds (`sp_chain_dec`, `sp_chain_mask`,
     `sp_chain_maskv`, `sp_pass_c_lean`) as every functor above (their
     em, ae and counts exactly), then bit for bit against the split
     passes they replace (sp_chain, smax_scorer, em_ae, cnf_chain,
     sp_pass_c) from one loop state on the shared set, the compacted
     batch, the hub and both replicated, and timed three ways beside
     them;
  3. p-d-p path: compacting_solve at the headline settings (tolerance
     0.08, t_max 50, 1000 iterations, 1000 WalkSAT flips, restart schedule
     0.35/0.35/0.3, chunk 50, simplify_rounds 1) on the shared set
     (fingerprint d3cba04af19db12d), every solution verified with numpy
     against its CNF; the solved fraction must be >= 0.60 and every kernel
     of the path launched at least once. Its loop is the JAX package's
     chip default, with every sweep fold: `sp_chain_maskv` and
     `sp_pass_c_lean` launched, and no sp_chain, sp_pass_c, smax_scorer or
     em_ae;
  4. np-nd-np path: compacting_solve with the trained r3 checkpoint at
     full width (hidden 150; 1000 iterations, 1000 WalkSAT flips, chunk
     50) on the same set, every solution verified with numpy; the solved
     fraction must be >= 0.45 and kernels 6 and 7 launched at least once;
  5. walk-sat path: compacting_solve at the solver table's settings (1000
     WalkSAT flips from a random fill, epsilon 0.5), every solution
     verified with numpy; >= 7/128 solved;
  6. reinforce path: the same with REINFORCE (pi 0.01, decimation
     probability 0.5, 1000 iterations); >= 5/128 solved, kernel 4 and
     fused_edge_pass[scorer] launched. Then the REINFORCE forward from one
     injected state at full size, on the card and on the CPU (p = 1):
     after 1 iteration forces, predictions and active flags equal except
     at variables whose CPU |score| < 1e-5 (counted), SP messages to rtol
     1e-5 / atol 1e-6; after 10 iterations under 1% of the forces differ;
  7. p-d-p with PDP_SP_SWEEP=on PDP_SWEEP_DEC_FOLD=off (the folds bypass
     kernel 9, as in the JAX package): phase 34's unfolded solve through
     the one-launch sweep; >= 0.60 solved and kernel 9 launched once per
     iteration;
  8. p-nd-np path: compacting_solve with the trained r4 checkpoint at full
     width (hidden 150; 1000 iterations, 1000 WalkSAT flips, chunk 50),
     every solution verified with numpy; >= 28/128 solved and the log-input
     sweep, kernel 6, the verification, the masks and WalkSAT launched;
  9. p-nd-np with PDP_SP_SWEEP=on PDP_VERIFY_MASKS=on: phase 8's solve
     through kernel 9 (login) and kernel 10, each launched once per
     iteration (equal counts) and no `sp_chain_login` or `em_ae` left;
     >= 28/128 solved, printed beside phase 8's count;
 10. np-d-np path: compacting_solve with the trained r4 checkpoint at
     full width (hidden 150; 1000 iterations, 1000 WalkSAT flips,
     tolerance 0.02, t_max 10, chunk 50) on the shared set, every solution
     verified with numpy and printed beside the JAX package's 5, 5 and 1
     of 128; the decimator's pass (`smax`, kernel 1), kernels 6 and 7, the
     masks, the simplification, the verification and WalkSAT launched;
 11. np-d-np on the medium 3-SAT band (48 instances, n 60, alpha 3.5, 300
     iterations, decimation only), trained and from a fresh init, every
     solution verified with numpy: the trained run solves >= 29/48 (JAX
     0.8125) and at least 0.30 more than the fresh init (JAX 0.083);
 12. p-d-p compacting_solve(replicas=2) at the headline settings: >= 0.60
     solved, printed beside phase 3's count;
 13. p-d-p forward(replication=2) on the shared set (300 iterations, 200
     WalkSAT flips, check_termination): every deduplicated solution
     verified with numpy and against the solver's flags, and the
     replicated walk launched once a block (25 launches). Then the same
     forward from one injected state on the card and on the CPU, folded
     on both (PDP_FUSED_PASS=on on the CPU, whose default is the unfolded
     path): after 1
     iteration every state column on every edge to rtol 1e-5 / atol
     1e-6 and the carry (the problem, the flags, the edge mask) exactly;
     after 30 under 1% of the variables' flags or values differ;
 14. seeds 1 and 2 of p-d-p and reinforce, printed with seed 0 beside
     the counts from before kernel 2's var phase took the walk's order;
 15. np-nd-np in bf16 (compute_dtype="bfloat16"): phase 4's solve, >=
     0.45 solved (the f32 gate), printed beside phase 4's count; the bf16
     kernels 6 and 7 launched and their f32 instantiations never. Then
     the JAX package's own bf16 test (tests/test_bf16.py, hidden 16,
     fresh parameters, 5 iterations) on the card: f32 against bf16 max
     |prediction difference| <= 0.05, its tolerance. Then np-nd-np with
     the r3 weights from one numpy state on 16 4-SAT instances
     (neural.BF16_CHECK; 4 solved within 10 iterations), after 5 and 10
     iterations: the card's and the CPU's bf16 active flags equal, and
     the card's f32-against-bf16 max |prediction difference| and its bf16
     predictions' difference from the CPU's each <= 1.5 times JAX's own
     f32-against-bf16 difference from that state (0.0408 and 0.0610,
     which tests/test_torch_bf16.py recomputes);
 16. p-nd-np in bf16: phase 8's solve, >= 28/128, beside phase 8's count;
 17. np-d-np in bf16 on phase 11's 3-SAT band: >= 29/48, beside phase
     11's count;
 18. the flagship serving config (config/Predict/PDP-np-nd-np-trained.yaml:
     np-nd-np with trained-models/np-nd-np-full in bf16, 100 iterations,
     100 flips, epsilon 0.5) on the shared set, every solution verified
     with numpy; the solved count and the wall time recorded;
 19. gradients on the card against the CPU: np-nd-np at the flagship
     widths with the r3 weights, on one 32,768-edge segment of the
     flagship training mixture (utils/training.py flagship_segments, seed
     3), T = 10, dropout 0, one numpy init state, global_step 10: the BPTT
     loss to rtol 1e-5 and every parameter's gradient to ||g_card -
     g_cpu|| <= 1e-3 ||g_cpu||; no plain route runs on the card (each
     plain version raises there), and the counts read during backward()
     alone show kernel 6 launched as Gather2d's backward and kernel 7 as
     SegmentSum2d's, over both CSRs;
 20. training at the flagship recipe: SatTrainer from a fresh seeded init
     (utils/training.py FLAGSHIP_RECIPE: T = 10, remat on, dropout 0.2, lr
     1e-4) for TRAIN_STEPS steps at the fixed dims (8192, 32768, 131072,
     128) on the mixture stream (its segments generated first, as
     set-up): every loss finite, and the energy of a held-out segment at
     global_step 10 from one numpy init state lower after the steps than
     before; ms per step, instances per second, peak memory, and the
     launches of kernels 6 and 7 in one step, forward (with remat's
     recompute) and backward, are recorded; the backward forms of kernels
     6 and 7 over both CSRs are then held against their plain versions at
     that shape and timed beside index_add_ / index_select, kernel 6's
     (with the largest degree Gather2d's backward hands it) also bit for
     bit against walk_order_sum_2d and within REDUCE2D_TOL of float64,
     and its forward forms at that shape as in phase 2;
 21. fine-tune, save, reload, serve: 50 steps from the r3 weights (a
     params-only checkpoint: Adam starts fresh, as in the JAX package),
     best and last saved in the JAX package's format, read back through
     convert.load_jax_checkpoint and params_from_jax bit for bit, then
     phase 4's solve of the shared set with the fine-tuned weights (1000
     iterations, 1000 flips): >= 0.45 solved, printed beside phase 4's;
 22. gradients on the card against the CPU for p-nd-np: the r4 weights,
     one 32,768-edge segment of the r4 runs' stream (utils/training.py
     family_segments, seed 3), T = 10, dropout 0, one numpy init state,
     global_step 10: the loss to rtol 1e-4 and every gradient to 1e-3
     relative; no plain route on the card; the SP sweep on its training
     route (no sp_chain_login, sp_pass_c or kernel 9 launch in the step),
     kernel 4 forward in the step and its rule during backward() alone
     (`segment_sum_cols.backward_calls`), kernel 7 as SegmentSum2d's
     backward;
 23. the same for np-d-np, whose decimated problem after each outer step
     must be equal on the card and on the CPU (where a pick differs: the
     instance, the CPU's |score| gap, which must be < 1e-5, and the
     gradients then gated at the steps before it); kernels 1 (smax) and
     2 (sround) launched in the step on detached inputs, kernels 6 and 7
     as each other's backward over both CSRs;
 24. FAMILY_STEPS steps of each recipe (FAMILY_RECIPES) from a fresh
     seeded init at the fixed dims on one set of segments of the stream,
     generated first: every loss finite, the held-out energy (global_step
     10, one numpy init state) lower after than before; ms a step,
     instances/s, peak memory and each kernel's launches in one step
     recorded; then 10 steps of config/Train/p-nd-np-cnf-3-10.yaml
     (through utils/config.py; its dict in utils/training.py where PyYAML
     is missing) with meta width 1 and zeros injected, every loss finite;
 25. resume each r4 train state (params and Adam: p-nd-np-r4/best,
     np-d-np-r4/last), 20 steps, best and last saved in the JAX package's
     format and read back bit for bit, then served: p-nd-np with phase
     8's solve (>= 28/128, beside phase 8's count), np-d-np on phase 11's
     band (>= 29/48, beside phase 11's);
 26. satyr -d (cli/satyr.py, in this process) on the shared set written
     as 128 DIMACS files, np-nd-np r3 (config/Predict/PDP-np-nd-np-r3.yaml,
     1000 iterations and flips, one monolithic forward): the rows in file
     order named by their files, each row's unsat_clauses and solved held
     against numpy, temp_problem_file.json removed, kernels 6, 7 and 3
     launched, >= 45/128 solved (printed beside phase 4's);
 27. satyr as a process on datasets/sample_3sat.json with p-d-p and
     PDP_PROFILE=1 (JAX's quickstart test): rc 0, >= 16/20 solved and
     verified, one PDP_PROFILE line with solve, output and three slopes >
     0 (WalkSAT's on the sample with an unsatisfiable group of clauses
     added, utils/profiler.py unsatisfiable_probe, so that every timed
     iteration walks); SatTrainer(config).predict in this process writes
     the same lines;
 28. generate with --label on the card (two bands of 32, uniform 3-SAT, n
     40, alpha 3-4): every DIMACS file converts back to its row, >= 24/32
     of the lower band labelled 1, kernels 1-3 launched; then 8 modular
     instances (n 1000) reordered, solved by p-d-p at the headline
     settings with 10 flips a variable (>= 4/8), and every solved one's
     restored assignment verified against its original clauses;
 29. satyr_train_test -g (config/Train/np-nd-np-uniform.yaml, 2 epochs of
     128 generated instances, hidden 150, T = 10) then -t -l best on phase
     28's data: best and last read back bit for bit, losses and errors
     finite, both CSVs with a row per JSON file from each run, every
     accuracy and recall equal (to 1e-6) to numpy's recomputation of
     JAX's formula from that test's predictions and labels, and the
     results CSV's recall equal to it; every accuracy in [0, 1] for
     {0, 1} labels, in [-1, 1] for generate's {1, -1} ones, where recall
     has no bound (ROADMAP.md section 3); ms a step recorded;
 30. multi-card serving (parallel/mesh.py), ranks spawned on the one
     card (2 gloo ranks, their collectives staged through the host): the
     data-parallel solve of the shared set, 64 instances a rank, p-d-p at
     the headline solver settings with replication 2 (>= MIN_SOLVED) and
     np-nd-np r3 (>= MIN_SOLVED_NEURAL), every solution verified with
     numpy and each rank's predictions equal to its serial forward from
     the same state (p-d-p exactly, np-nd-np to DP_PRED_ATOL, flags
     equal); the replica-parallel p-d-p solve on a (1, 2) mesh (>=
     MIN_SOLVED_ONE_ATTEMPT); p-d-p on 1 NCCL rank (>= MIN_SOLVED); satyr
     under torchrun --nproc-per-node 2 writing phase 27's lines;
 31. one flagship-recipe train step on 2 ranks (flagship segment dims):
     the parameters equal to a serial step on the mean of the two
     segments' gradients (TRAIN_DP_ATOL); ms a step and each rank's
     kernel span recorded;
 32. the edge-sharded SP marginals of one 4-SAT instance (n 100,000,
     alpha 9, 3.6M edges) on 2 ranks against 1 (EDGE_SP_TOL), ms a sweep;
     the edge-sharded p-d-p solve of 16 instances of the shared set on 2
     ranks equal to 1 rank's from the same generator state (solutions
     and flags), >= MIN_SOLVED_EDGE, every reported solution verified
     with numpy, the ranks in lockstep;
 33. parallel_compacting_solve on 2 ranks over the shared set (every
     solution verified, >= MIN_SOLVED_ONE_ATTEMPT, the same lists on both
     ranks); resilient_solve of the shared set uninterrupted (0 retries),
     with a fault injected at chunk 2 (1 retry, the same prediction), and
     in two processes: the first killed after 2 chunks, the second
     resuming from its checkpoint to the same prediction bit for bit.
     Every launch count of phases 30-33 is read in the rank's process
     and summed over ranks; no retry happens in any process but the
     injected one;
 34. (run right after phase 3) p-d-p unfolded (PDP_SWEEP_DEC_FOLD=off):
     phase 3's solve through the split passes, >= 0.60, printed beside
     phase 3's count, no fold launched; with PDP_SWEEP_MASK_FOLD=off
     (the decimator fold alone) and with PDP_SWEEP_VERIFY_FOLD=off (the
     mask fold too): each the unfolded run's count, since their passes
     give the split passes' bits; then phase 13's card-against-CPU check
     on the folded forward(replication=1);
 35. the {"kernels": [...]} line (each row with the launches of phase 26's
     serve and of phases 30-33's paths beside its own path's; the split
     passes' with phase 34's unfolded run, sp_chain_dec's and
     sp_chain_mask's with its partial fold runs), the card's name and
     power limit, and as the last line {"ok": true, "device": {...}}.

Phases 4, 8, 10, 11, 15 and 16's solved counts are held equal to the
counts the card gave before the clamp-tie rule of ops/segment.py, which
changes no forward value.

Every launch count is set to 0 just before each path and read just after
it; a kernel's row carries the count of the path it serves.

Any failure exits non-zero without the last line. Without a CUDA card, or
run outside the repository, it exits 2 and prints no result.
"""

import csv
import json
import os
import subprocess
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the JAX package's records at the headline settings: 70.1% (seeds
# 69.5-71.1%); the port draws other random message inits
MIN_SOLVED = 0.60
# np-nd-np with the r3 weights: the JAX records are 0.516-0.602 (seeds 0-2,
# docs/r5_solver_table.json); WalkSAT from a random fill alone solves 0.117
MIN_SOLVED_NEURAL = 0.45
# walk-sat and reinforce at the solver table's settings: the JAX records
# are 13-16 and 11-17 of 128 (seeds 0-2, docs/r5_solver_table.json); a
# broken WalkSAT solves 0
MIN_SOLVED_WALK_SAT = 7
MIN_SOLVED_REINFORCE = 5
# p-nd-np with the r4 weights: the JAX records are 38, 45 and 43 of 128
# (seeds 0-2, docs/r5_solver_table.json); WalkSAT alone solves about 15
MIN_SOLVED_P_ND_NP = 28
# the kernels p-nd-np's path must launch: the SP sweep with log input,
# the predictor's per-variable sum (kernel 6; the predictor keeps the
# variable rows, so kernel 7's gather back to the edges is not on this
# path, in the JAX package either), the verification, the masks, WalkSAT
P_ND_NP_KERNELS = ("sp_chain_login", "sp_pass_c", "segment_sum_2d",
                   "cnf_chain", "em_ae", "walksat_walk")
# solved counts of seeds 0-2 on an H100 before kernel 2's var phase took
# the group walk's order (the same before and after kernels 1 and 4 took
# it; utils/profile_solve.py --seeds 0 1 2)
PRIOR_SOLVED = {"p-d-p": [86, 84, 87], "reinforce": [12, 16, 10]}
# card-vs-CPU REINFORCE forward: variables whose CPU |score| is below this
# may take either sign; the share of differing forces after 10 iterations
SCORE_TIE = 1e-5
MAX_FORCE_DIFF_SHARE = 0.01
# np-d-np with the r4 weights: the JAX records on the shared set are 5, 5
# and 1 of 128 (seeds 0-2, docs/r5_solver_table.json); on the medium
# 3-SAT band (decimation only) 0.8125 trained, 0.0833 untrained
# (np_d_np_3sat there). The band's gates: at least 0.60 trained, and at
# least 0.30 above a fresh init
JAX_NP_D_NP = [5, 5, 1]
JAX_BAND = {"trained": 0.8125, "untrained": 0.0833}
MIN_BAND_SOLVED = 29
MIN_BAND_GAIN = 0.30
# the kernels np-d-np's path must launch: its decimator's pass (smax), the
# masks, the simplification, the verification, the aggregators' sum and
# gather (kernels 6, 7) and WalkSAT
NP_D_NP_KERNELS = ("smax", "em", "em_ae", "sround", "cnf_chain",
                   "segment_sum_2d", "gather_2d", "walksat_walk")
# the replicated p-d-p forward of phase 13
REP_ITERATIONS, REP_FLIPS = 300, 200
# its card-against-CPU comparison: iterations run on each side (the
# headline decimator's first fixes come after ~20)
REP_CMP_ITERATIONS = 30
REDUCE2D_TOL = dict(rtol=1e-5, atol=1e-5)
# compute_dtype="bfloat16" (phases 15-18). JAX's own test of bf16
# (tests/test_bf16.py: np-nd-np at these widths with fresh parameters,
# three random 3-SAT instances of 10 variables and 25 clauses, 5
# iterations) run on the card, with its tolerance on the f32-against-bf16
# prediction difference (:34); the check at the r3 weights from one state
# is neural.BF16_CHECK's
BF16 = "bfloat16"
BF16_SMALL = dict(hidden_dim=16, mem_hidden_dim=8, agg_hidden_dim=8,
                  mem_agg_hidden_dim=8, classifier_dim=8)
BF16_SMALL_ITERATIONS = 5
MAX_BF16_PRED_DIFF = 0.05
HIDDEN_AGG = 50      # np-nd-np's mem_agg_hidden_dim: the width kernels 6/7 see
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
# functors whose outputs are flags or small integer counts
EXACT_FNS = {"em_ae", "em", "ae", "sround", "cnf_chain", "ws_chain"}
# the sweep folds' flag and count outputs, by index among a pass's flat
# outputs (vred, eta, em, ae, then the verification's counts)
EXACT_OUTPUTS = {"sp_chain_mask": {2, 3}, "sp_chain_maskv": {2, 3, 4}}
# the folded p-d-p loop (phase 3, JAX's chip default): its sweep and lean
# pass C launched, the split passes they replace never
FOLDED_PDP_KERNELS = ("sp_chain_maskv", "sp_pass_c_lean", "sround",
                      "cnf_chain", "walksat_walk")
SPLIT_PDP_KERNELS = ("sp_chain", "sp_pass_c", "smax_scorer", "em_ae")
FOLD_KERNELS = ("sp_chain_dec", "sp_chain_mask", "sp_chain_maskv",
                "sp_pass_c_lean")
# training (phases 19-21): the card-against-CPU gradient check's segment
# (V, F, E, B), a quarter of the flagship run's fixed dims, and its gates
TRAIN_GRAD_DIMS = (2048, 8192, 32768, 32)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-3
# the training phases run 50 steps a recipe (they ran 100 before the
# multi-card phases came): the script's host-bound phases ran 1.5x slower
# on one H100 machine than on another, and the whole script must end
# inside its 1200 s
TRAIN_STEPS, FINETUNE_STEPS = 50, 50
TRAIN_EVAL_STEP = 10.0    # the global_step of the gradient and held-out runs
# p-nd-np and np-d-np training (phases 22-25): the card-against-CPU gates
# (T = 10 outer steps at hidden 150), the score gap under which a
# decimation pick may differ, the steps of each phase, and the r4 train
# states resumed
FAMILY = ("p-nd-np", "np-d-np")
FAMILY_LOSS_RTOL = 1e-4
PICK_TIE_GAP = 1e-5
FAMILY_STEPS, RESUME_STEPS, META_STEPS = 50, 20, 10
R4_STATE = {"p-nd-np": "trained-models/p-nd-np-r4/best",
            "np-d-np": "trained-models/np-d-np-r4/last"}
# the kernels a p-nd-np training step must not launch: the serving
# sweep's (kernel 2's login functor, kernel 1's pass C, kernel 9)
SERVING_SWEEP = ("sp_chain_login", "sp_pass_c", "sp_full_sweep")
# the solved counts of phases 4, 15, 8, 16, 10 and 11 on an H100 before
# the clamp-tie rule (ops/segment.py clamp_min / clamp_max)
SERVING_SOLVED = {"np-nd-np": 71, "np-nd-np bf16": 74, "p-nd-np": 48,
               "p-nd-np bf16": 45, "np-d-np": 4, "np-d-np band": 38}
# the command lines (phases 26-29). Phase 26: np-nd-np r3 through satyr
# from DIMACS files, one monolithic forward of 1000 iterations and 1000
# flips (no compaction), gated at 0.35 of the shared set (WalkSAT alone
# from a random fill solves ~0.12), and the kernels it must launch
CLI_R3_YAML = "config/Predict/PDP-np-nd-np-r3.yaml"
CLI_ITERATIONS = 1000
MIN_SOLVED_CLI = 45
CLI_KERNELS = ("segment_sum_2d", "gather_2d", "walksat_walk")
# phase 27: JAX's quickstart test (tests/test_cli.py:73) as a process
CLI_PDP_YAML = "config/Predict/PDP-p-d-p-sp.yaml"
CLI_SAMPLE = "datasets/sample_3sat.json"
MIN_SOLVED_SAMPLE = 16
SLOPE_KEYS = ("sp_sweep_ms", "walksat_iter_ms", "pdp_iteration_ms")
# phase 29: a test metric against numpy's recomputation of JAX's formula
METRIC_ATOL = 1e-6
# phase 28: generate's two 32-instance bands of uniform 3-SAT (n 40, alpha
# 3-4), labelled on the card, and the reorder path on tools/
# eval_modular.py:62-63's modular generator at n 1000
GENERATE_ARGS = ["band", "32", "uniform", "--min_n", "40", "--max_n", "40",
                 "--min_k", "3", "--max_k", "3", "--min_a", "3.0",
                 "--max_a", "4.0", "--res", "2", "--label", "--seed", "3"]
MIN_LABELLED_LOW_BAND = 24
MODULAR_N1000 = dict(k=3, min_n=1000, max_n=1000, min_q=0.8, max_q=0.9,
                     min_c=10, max_c=20, min_a=3.0, max_a=3.0, seed=11)
MODULAR_COUNT = 8
# the headline settings but WalkSAT's budget scaled with n as
# tools/eval_modular.py:46-52 does: the reference's 1000 flips at n <= 100
# are 10 a variable (the headline's 1000 flips solved 0/8 at n 1000 on an
# H100); at least half solved, so that the restore check sees solutions
MODULAR_FLIPS_PER_VAR = 10
MIN_SOLVED_MODULAR = 4
# phase 29: config/Train/np-nd-np-uniform.yaml with only these keys
# changed (the paths are phase 28's and a temporary directory's; 128
# instances an epoch, for the script's time)
TRAIN_CLI_KEYS = dict(epoch_num=2, train_epoch_size=128,
                      test_recurrence_num=100)
TRAIN_CLI_YAML = "config/Train/np-nd-np-uniform.yaml"
# phases 30-33: multi-card execution on the one card. DP_RANKS gloo ranks
# share it (their collectives staged through the host); phase 30 also
# runs one NCCL rank. Phase 30: make_parallel_solve of the shared set, 64
# instances a rank: p-d-p at the headline solver settings, one attempt of
# 1000 iterations and 1000 flips with in-batch replication 2 (a forward
# has no restart schedule), gated at phase 3's limit; np-nd-np r3 at 1000
# iterations and flips, gated at phase 4's; each rank's predictions held
# against the serial forward of its instances from the same state: p-d-p
# exactly, np-nd-np to DP_PRED_ATOL, the flags equal. np-nd-np runs 500
# iterations (phase 4's compacting solve had solved 61/128 by then) to
# keep the phase short. The replica-parallel solve (each rank the whole
# set, one attempt, no replication) and phase 33's compacting solve over
# ranks (one attempt) are gated at MIN_SOLVED_ONE_ATTEMPT: on an H100 one
# attempt solved 68-75/128 over seeds 0-9 (mean 71.3, sd 2.1) and walk-sat
# 8-23/128 (utils/profile_solve.py --settings one-attempt, --model
# walk-sat), so 64/128 sits 4 below the lowest one-attempt reading (3.4
# sd below the mean) and 41 above walk-sat's highest
DP_RANKS = 2
DP_SEED = 30
DP_PDP_REPLICATION = 2
DP_NP_ND_NP_ITERATIONS = 500
MIN_SOLVED_ONE_ATTEMPT = 0.50
DP_PRED_ATOL = 1e-5
# phase 31: the flagship-recipe step on two segments against a serial
# step on the mean of their gradients (tests/test_torch_train.py's
# parameter tolerance)
TRAIN_DP_SEED, TRAIN_DP_TIMED, TRAIN_DP_ATOL = 31, 3, 1e-6
# phase 32: SP on one 4-SAT instance, n 100,000, alpha 9 (3.6M edges), 2
# ranks against 1 to the tolerance of JAX's test_edge_sharded_sp_matches_
# single_device; the edge-sharded p-d-p solve of the shared set's first 16
# at the headline's tolerance, t_max, iterations and flips, on 2 ranks and
# on 1 from the same generator state (the shards split at an instance
# boundary, so both draw the same init messages, and every variable's and
# clause's sum is taken in one shard): the two give the same solutions
# and flags (the sums have a fixed order and no atomics, so a run repeats
# its bits). Each solves at least MIN_SOLVED_EDGE: walk-sat from a random
# fill solved 0.06-0.18 of the shared set on an H100 (mean 0.12: ~2 of 16,
# and 5 or more with a chance of ~3%), one attempt of p-d-p 0.53-0.59
# (seeds 0-9, utils/profile_solve.py)
EDGE_SP_N, EDGE_SP_ALPHA, EDGE_SP_SWEEPS, EDGE_SP_SEED = 100000, 9.0, 20, 32
EDGE_SP_TOL = dict(rtol=1e-4, atol=1e-5)
EDGE_SOLVE_COUNT, EDGE_SOLVE_SEED = 16, 33
EDGE_SOLVE = dict(iteration_num=1000, tolerance=0.08, t_max=50.0,
                  ls_iterations=1000, epsilon=0.5)
MIN_SOLVED_EDGE = 5
# phase 33: parallel_compacting_solve of the shared set (one attempt at the
# headline solver settings); the resilient solve of the shared set (400
# iterations in chunks of 100), killed after 2 chunks and resumed in a new
# process
MESH_SEED = 34
RESILIENT_ITERATIONS, RESILIENT_CHUNK, RESILIENT_STOP = 400, 100, 2
KILLED_RC = 17
RANK_TIMEOUT = 600
PALLAS_FUSED = "pdp_solver_tpu/ops/pallas_fused.py"
PALLAS_2D = "pdp_solver_tpu/ops/pallas_reduce2d.py"
REDUCE_CU = "pdp_solver_tpu_torch/csrc/reduce.cu"


def log(msg):
    print(f"[chip_smoke {time.time() - T0:8.2f}s] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timing_note(t):
    return (f"{t['ms']:.4f} ms, host {t['host_us']:.1f} us, device "
            f"{t['device_us']:.2f} us")


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def fn_inputs(fn, batch, seed, active_mask=False):
    """Seeded inputs at the batch's shapes, each drawn like the column its
    name says it is (0/1 masks are 0 on padding). With active_mask the SP
    passes' `mask` is drawn as the solver's active-edge flag, which is 1
    on padding edges too (their variable's instance is active)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    real = {"V": batch.var_mask, "F": batch.clause_mask,
            "E": batch.edge_mask}
    out = []
    for kind, name in zip(fn.layout, fn.inputs):
        u = torch.rand(sizes[kind], generator=g).to(batch.device)
        if name == "sign":
            x = batch.edge_sign
        elif name == "mask" and active_mask and fn.name.startswith("sp_"):
            x = (u > 0.2).float()
        elif name in ("mask", "bmask"):
            x = batch.edge_mask
        elif name in ("force", "sa"):
            x = torch.where(u > 0.5, 1.0, -1.0) * real[kind]
        elif name in ("em", "av", "abv", "ac", "cm"):
            x = (u > 0.2).float() * real[kind]
        elif name == "sol":
            x = torch.floor(u * 3.0) / 2.0
        elif name in ("pos", "neg"):
            x = -5.0 * u
        elif name == "log_u_in":
            x = torch.log(u * 0.96 + 0.02)
        else:
            x = u * 0.96 + 0.02
        out.append(x.contiguous())
    return out


def fused_bytes(fn, batch, chained):
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    E, V, F, B = (batch.num_edges, batch.num_vars, batch.num_clauses,
                  batch.batch_size)
    n = sum(sizes[k] for k in fn.layout) * 4
    if chained:
        n += 2 * E * 4                              # edge_var, edge_clause
        n += F * 4 if fn.n_ired else 0              # clause_batch
        n += (fn.n_cout * F + fn.n_vred * V + fn.n_eout * E
              + fn.n_ired * B) * 4
    else:
        uses_v = "V" in fn.layout or fn.side == "var"
        uses_f = "F" in fn.layout or fn.side == "clause"
        n += (uses_v + uses_f) * E * 4
        seg = {"var": V, "clause": F, "none": 0}[fn.side]
        n += (fn.n_red * seg + fn.n_eout * E) * 4
    return n


def _flat(outs):
    """The tensors of a pass's outputs, edge outputs unpacked."""
    flat = []
    for o in outs:
        if isinstance(o, tuple):
            flat += list(o)
        elif o is not None:
            flat.append(o)
    return flat


def hold_pass(fn, batch, ins, torch, label=""):
    """One fused or chained pass on the card against its plain version on
    the same inputs, on every output row (flags and counts exactly, else
    FLOAT_TOL); where it walks the variables, the same bits on a second
    call; a chained pass's variable sums the bits of the walk's order over
    the plain terms. Returns (max abs err, the checks beyond the plain
    version that held)."""
    from pdp_solver_tpu_torch.ops import fused
    chained = fn in fused.CHAINED_FNS
    call = fused.chained_edge_pass if chained else fused.fused_edge_pass
    plain = (fused.chained_edge_pass_plain if chained
             else fused.fused_edge_pass_plain)
    what = f"{fn.name}{label}"
    ref = plain(fn, batch, ins)
    got = call(fn, batch, ins)
    torch.cuda.synchronize()
    err = 0.0
    for r, o in zip(ref, got):
        require((r is None) == (o is None), f"{what}: unexpected output")
    refs, gots = _flat(ref), _flat(got)
    exact = EXACT_OUTPUTS.get(fn.name, ())
    for i, (r, o) in enumerate(zip(refs, gots)):
        require(r.shape == o.shape, f"{what}: shape {tuple(o.shape)}"
                f" != {tuple(r.shape)}")
        require(bool(torch.isfinite(o).all()), f"{what}: non-finite")
        err = max(err, float((o - r).abs().max()))
        if fn.name in EXACT_FNS or i in exact:
            require(torch.equal(o, r), f"{what}: not exact "
                    f"(max abs err {err})")
        else:
            ok = torch.allclose(o, r, **FLOAT_TOL)
            require(ok, f"{what}: max abs err {err} beyond "
                    f"rtol {FLOAT_TOL['rtol']} / atol "
                    f"{FLOAT_TOL['atol']}")
    extra = {}
    if chained or fn.side == "var":
        # the group walk: the same bits on a second call
        again = call(fn, batch, ins)
        torch.cuda.synchronize()
        require(all(torch.equal(o, a) for o, a in zip(
            gots, _flat(again))), f"{what}: two calls differ")
        extra["twice_equal"] = True
    if chained and fn.n_vred:
        # the variable sums in the walk's order over the plain terms
        emu = fused.chained_vred_walk_order(fn, batch, ins)
        torch.cuda.synchronize()
        require(torch.equal(got[1], emu), f"{what}: not the walk's "
                f"order (max abs diff "
                f"{float((got[1] - emu).abs().max()):.3g})")
        extra["walk_order_bits"] = True
    return err, extra


def check_kernels(batch, torch, np):
    from pdp_solver_tpu_torch.ops import fused
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    rows = {}
    for fn in fused.FUSED_FNS + fused.CHAINED_FNS:
        chained = fn in fused.CHAINED_FNS
        call = fused.chained_edge_pass if chained else fused.fused_edge_pass
        plain = (fused.chained_edge_pass_plain if chained
                 else fused.fused_edge_pass_plain)
        ins = fn_inputs(fn, batch, seed=len(rows) + 1)
        err, extra = hold_pass(fn, batch, ins, torch)
        extra.update(timed(lambda: call(fn, batch, ins)))
        ms = extra.pop("ms")
        plain_ms = cuda_ms(lambda: plain(fn, batch, ins), reps=10)
        # one PyTorch call computes the same function only for the plain
        # gather `ae` (an index_select); the others have none
        library_ms = None
        if fn.name == "ae":
            lib = timed(lambda: ins[0][batch.edge_var])
            library_ms = lib["ms"]
            extra.update(library_host_us=lib["host_us"],
                         library_device_us=lib["device_us"])
        b_ms, b_by = bound_ms(fused_bytes(fn, batch, chained),
                              fn.flops * batch.num_edges)
        name = ("chained_edge_pass" if chained else "fused_edge_pass")
        rows[fn.name] = dict({
            "name": f"{name}[{fn.name}]", "route": "cuda",
            "source": "pdp_solver_tpu_torch/csrc/edge_pass.cu",
            "replaces": f"{PALLAS_FUSED}:{442 if chained else 553}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms},
            **extra)
        lib = ("" if library_ms is None else f", library {library_ms:.4f} ms"
               f" (host {extra['library_host_us']:.1f} us, device "
               f"{extra['library_device_us']:.2f} us)")
        checks = "".join(f", {k.replace('_', ' ')}" for k in (
            "twice_equal", "walk_order_bits") if k in extra)
        log(f"kernel {rows[fn.name]['name']}: ok, max abs err {err:.3g}"
            f"{checks}; {timing_note(dict(extra, ms=ms))} (plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms{lib})")

    return rows


def check_kernels_replicated(insts, torch):
    """Kernels 1 and 2 on the replicated layout (`replicate_batch`, R =
    2): every fused and chained functor on the shared set and on a
    compacted batch (8 instances of 128 rows), each replicated twice, so
    that the prefix the kernels treat as real holds replica 0's padding
    edges, clauses, variables and rows. Each is held as in phase 2
    (`hold_pass`, every output row, padding included), the SP passes'
    mask drawn as the solver's active-edge flag (1 on padding edges).
    Returns {functor: {shape: max abs err}}."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances, replicate_batch
    from pdp_solver_tpu_torch.ops import fused
    errs = {}
    for label, sub in (("shared", insts), ("compacted", insts[:8])):
        b = replicate_batch(pack_instances(sub, device="cuda"), 2)
        require(b.inner_padding, f"replicated {label}: no padding inside "
                "the real prefix")
        for i, fn in enumerate(fused.FUSED_FNS + fused.CHAINED_FNS):
            ins = fn_inputs(fn, b, seed=100 + i, active_mask=True)
            err, extra = hold_pass(fn, b, ins, torch,
                                   label=f" (replicated {label})")
            errs.setdefault(fn.name, {})[label] = err
        log(f"kernels 1-2 on the replicated {label} batch (E={b.num_edges},"
            f" {b.num_real_edges - b.real.num_edges} padding edges inside "
            f"the prefix): every functor matches its plain version")
    return errs


def check_folds(insts, torch):
    """The sweep folds on the card against the split passes they replace
    (utils/bench_kernels.py split_sweep, folded_sweep), on one state of
    the p-d-p loop (`fold_inputs`) of the shared set, a compacted batch
    (8 instances), the hub and both replicated twice: sp_chain_dec,
    sp_chain_mask and sp_chain_maskv, each followed by sp_pass_c_lean,
    give the split path's variable sums (sp_chain's two, then
    smax_scorer's eight), eta, em, ae, q_u and the verification's counts
    bit for bit. On the shared set each fold and the lean pass C are then
    timed three ways beside the split launches they replace, and one
    loop iteration's sweep folded beside split. Returns {functor:
    numbers}."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances, replicate_batch
    from pdp_solver_tpu_torch.ops import fused
    from pdp_solver_tpu_torch.utils.bench_kernels import (
        fold_inputs, folded_sweep, hub_batch, split_sweep, timed)
    full = pack_instances(insts, device="cuda")
    small = pack_instances(insts[:8], device="cuda")
    shapes = {"shared": full, "compacted": small, "hub": hub_batch(),
              "replicated shared": replicate_batch(full, 2),
              "replicated compacted": replicate_batch(small, 2)}
    for label, b in shapes.items():
        x = fold_inputs(b)
        split = split_sweep(b, x)
        for fold in ("dec", "mask", "maskv"):
            got = folded_sweep(b, x, fold)
            torch.cuda.synchronize()
            for key, out in got.items():
                ref = split[key]
                diff = float((out - ref).abs().max())
                require(torch.equal(out, ref), f"sp_chain_{fold} ({label}):"
                        f" {key} is not the split path's bits (max abs "
                        f"diff {diff:.3g})")
    log("sweep folds: sp_chain_dec, sp_chain_mask and sp_chain_maskv with "
        "sp_pass_c_lean give the split path's bits (sums, eta, em, ae, "
        f"q_u, counts) on {', '.join(shapes)}")
    b, x = full, fold_inputs(full)
    out = {}
    F = fused
    em, ae = F.fused_edge_pass(F.EM_AE, b, (x["av"], x["abv"], x["ac"],
                                            x["bmask"]))[1]
    edges = (x["u_in"], x["eta_in"], x["eta_state"], x["sign"], x["force"],
             x["bmask"])
    _, pn, (eta,), _ = F.chained_edge_pass(F.SP_CHAIN, b, (
        x["u_in"], x["eta_in"], em, ae, x["eta_state"], x["sign"]))
    calls = {
        "em_ae": lambda: F.fused_edge_pass(
            F.EM_AE, b, (x["av"], x["abv"], x["ac"], x["bmask"])),
        "sp_chain": lambda: F.chained_edge_pass(F.SP_CHAIN, b, (
            x["u_in"], x["eta_in"], em, ae, x["eta_state"], x["sign"])),
        "smax_scorer": lambda: F.fused_edge_pass(F.SMAX_SCORER, b, (
            x["ac"], x["eta_state"], eta, em, x["bmask"], x["force"],
            x["sign"])),
        "cnf_chain": lambda: F.chained_edge_pass(F.CNF_CHAIN, b, (
            x["sol"], x["sign"], x["bmask"], x["cm"])),
        "sp_pass_c": lambda: F.fused_edge_pass(F.SP_PASS_C, b, (
            pn[0], pn[1], x["eta_in"], em, ae, x["sign"], x["force"],
            x["v0"], x["v1"], x["v2"])),
        "sp_chain_dec": lambda: F.chained_edge_pass(F.SP_CHAIN_DEC, b, (
            x["ac"], x["u_in"], x["eta_in"], em, ae, x["eta_state"],
            x["sign"], x["force"], x["bmask"])),
        "sp_chain_mask": lambda: F.chained_edge_pass(
            F.SP_CHAIN_MASK, b, (x["av"], x["abv"], x["ac"]) + edges),
        "sp_chain_maskv": lambda: F.chained_edge_pass(
            F.SP_CHAIN_MASKV, b,
            (x["av"], x["abv"], x["sol"], x["ac"], x["cm"]) + edges),
        "sp_pass_c_lean": lambda: F.fused_edge_pass(F.SP_PASS_C_LEAN, b, (
            pn[0], pn[1], x["eta_in"], em, ae, x["sign"], x["force"],
            x["v0"])),
    }
    replaced = {"sp_chain_dec": ("sp_chain", "smax_scorer"),
                "sp_chain_mask": ("em_ae", "sp_chain", "smax_scorer"),
                "sp_chain_maskv": ("em_ae", "sp_chain", "smax_scorer",
                                   "cnf_chain"),
                "sp_pass_c_lean": ("sp_pass_c",)}
    for name, parts in replaced.items():
        kern = timed(calls[name])
        spl = timed(lambda: [calls[p]() for p in parts])
        out[name] = dict(
            fold_bits_equal_split=True, split_launches=list(parts),
            split_ms=spl["ms"], split_host_us=spl["host_us"],
            split_device_us=spl["device_us"],
            fold_device_us=kern["device_us"])
        log(f"{name}: {timing_note(kern)}; the split launches it replaces "
            f"({' + '.join(parts)}) {timing_note(spl)}")
    fold_t = timed(lambda: folded_sweep(b, x))
    split_t = timed(lambda: split_sweep(b, x))
    for name in replaced:
        out[name].update(sweep_folded_device_us=fold_t["device_us"],
                         sweep_split_device_us=split_t["device_us"])
    log(f"one loop iteration's sweep (shared set): folded (sp_chain_maskv "
        f"+ sp_pass_c_lean) {timing_note(fold_t)}; split (em_ae, sp_chain, "
        f"sp_pass_c, smax_scorer, cnf_chain) {timing_note(split_t)}")
    return out


# the numbers of blocks each WalkSAT shape is checked at: one, the old
# launch's 8 iterations a block run 8 times, and a 200-flip chunk
WALK_BLOCKS = (1, 8, 25)
# operations an edge of a clause and a variable of one WalkSAT iteration
WALK_EDGE_OPS, WALK_VAR_OPS = 10, 20


def walk_steps(walksat, batch, assign, kw, seeds, K, eps):
    """The plain walk one iteration at a time (block j's iteration kk is
    a one-iteration block salted seeds[j] + kk * 1000003): {blocks:
    (assign, energy)} after each of WALK_BLOCKS; the iterations each row
    runs in the kernel (up to and including the first whose entering
    energy is not positive); and the operations those iterations need
    a row. The clause phase of a row's first iteration takes every
    clause; each later one takes only the clauses of the variable the
    iteration before flipped (its real edges, times the clause width),
    since no other clause changed. The selection takes every variable,
    in the iterations that flip. The variables, clauses and edges are the
    rows' real ones (`batch.real`), which the kernel walks."""
    import torch
    dev = assign.device
    real = batch.real
    ivp = batch.inst_var_ptr[:-1].long()
    icp = batch.inst_clause_ptr[:-1].long()
    var_deg = (real.var_ptr[1:] - real.var_ptr[:-1]).double()
    vb = batch.var_batch.long()
    k = batch.clause_width
    every_clause = (WALK_EDGE_OPS * k
                    * (real.clause_end.long() - icp)).double()
    select = (WALK_VAR_OPS * (real.var_end.long() - ivp)).double()
    B = batch.batch_size
    snaps = {}
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros(B, dtype=torch.float64, device=dev)
    entering = torch.ones(B, dtype=torch.bool, device=dev)
    clause_ops = every_clause
    a = assign
    for j, seed in enumerate(seeds):
        for kk in range(K):
            a_next, e = walksat.walksat_block_plain(
                a, K=1, seed=walksat.wrap32(seed + kk * 1000003), eps=eps,
                **kw)
            run = entering & (e > 0)
            count += entering.long()
            ops += entering.double() * clause_ops + run.double() * select
            flipped = torch.zeros(B, dtype=torch.float64, device=dev)
            flipped.index_add_(0, vb, var_deg * (a_next != a).double())
            clause_ops = WALK_EDGE_OPS * k * flipped
            entering = run
            a = a_next
        if j + 1 in WALK_BLOCKS:
            snaps[j + 1] = (a, e)
    return snaps, count, ops


def walk_bound(batch, ops, n_blocks):
    """bound_ms of one walk: its inputs read once (ev, w, dm, em a real
    edge, ac a real clause, assign and av a variable, seeds) and its
    outputs written once (the assignment, the energies), or the
    operations (walk_steps) its instances' live iterations need. The real
    clauses and edges are the rows' (`batch.real`): a replicated batch's
    padding inside the prefix is none of the walk's work."""
    V, F, E = batch.num_vars, batch.real.num_clauses, batch.real.num_edges
    nbytes = 16 * E + 4 * F + 12 * V + 4 * batch.batch_size + 4 * n_blocks
    return bound_ms(nbytes, float(ops.sum()))


def check_walksat(insts, torch, np):
    """WalkSAT (kernel 3): one walksat_walk launch of 1, 8 and 25 blocks
    of K = 8 bit for bit against its plain version (assignments as int32
    views, energies exactly), greedy and eps 0.5, from two inputs (a
    problem with some variables and clauses inactive and a random
    prediction; a random fill of every variable, all active, every
    instance unsat, as the WalkSAT phase starts) on four shapes: the
    shared set, a compacted batch, the hub (one variable in 63,488
    clauses: edges in global memory) and a large banded instance (30,000
    variables: variables in global memory too). The one-block and
    25-block forms are then timed three ways on each shape. Returns the
    rows "walksat_block" (one block, shared set, the first input) and
    "walksat_walk" (25 blocks, shared set, the fill)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import walksat
    from pdp_solver_tpu_torch.utils.bench_kernels import (
        WALK_SEEDS, hub_batch, large_instance, timed, walk_inputs)
    K = 8
    shapes = {"shared": pack_instances(insts, device="cuda"),
              "compacted": pack_instances(insts[:8], device="cuda"),
              "hub": hub_batch(),
              "large": pack_instances([large_instance()], device="cuda")}
    g = torch.Generator().manual_seed(13)
    rows, cases = {}, {}
    for label, b in shapes.items():
        require(walksat.use_walksat_block(b), f"walksat: {label} is not "
                "taken by the block rule")
        shape = walksat.launch_shape(b)
        n = b.num_instances
        for fill in ("half", "unsat"):
            assign, av, ac, em = walk_inputs(b, fill)
            kw = dict(batch=b, active_vars=av, active_clauses=ac, em=em)
            for eps in (-1.0, 0.5):
                # the first seed: the one-block checks of earlier slices
                first = 11 if eps < 0 else -123456789
                seeds = [first] + [int(x) for x in torch.randint(
                    -(1 << 31), 1 << 31, (WALK_BLOCKS[-1] - 1,),
                    generator=g)]
                snaps, _, _ = walk_steps(walksat, b, assign, kw, seeds,
                                         K, eps)
                for nb in WALK_BLOCKS:
                    a_got, e_got = walksat.walksat_walk(
                        assign, seeds=seeds[:nb], K=K, eps=eps, **kw)
                    torch.cuda.synchronize()
                    a_ref, e_ref = snaps[nb]
                    same = (np.array_equal(
                        a_got.cpu().numpy().view(np.int32),
                        a_ref.cpu().numpy().view(np.int32))
                        and torch.equal(e_got, e_ref))
                    require(same, f"walksat_walk ({label}, {fill}, eps "
                            f"{eps}, {nb} blocks): not bit-exact, "
                            f"{int((a_got != a_ref).sum())} variables and "
                            f"{int((e_got != e_ref).sum())} energies differ")
                e_first = snaps[1][1][:n]
                if fill == "unsat":
                    _, e0 = walksat.walksat_block_plain(
                        assign, K=1, seed=0, eps=eps, **kw)
                    require(bool((e0[:n] > 0).all()), f"walksat ({label}):"
                            " the fill left an instance satisfied")
                require(float(e_first.sum()) > 0,
                        f"walksat ({label}, {fill}) had nothing to flip")
            # timing: eps 0.5, as the solver table's settings
            econst = walksat.walksat_edge_constants(b, av)
            tkw = dict(kw, K=K, eps=0.5, edge_constants=econst)
            reps = dict(reps=5, host_reps=5) if n == 1 else {}
            for form, seeds in (("block", [5]), ("walk", WALK_SEEDS)):
                t = timed(lambda: walksat.walksat_walk(
                    assign, seeds=seeds, **tkw), **reps)
                _, live, ops = walk_steps(walksat, b, assign, kw, seeds,
                                          K, 0.5)
                b_ms, b_by = walk_bound(b, ops, len(seeds))
                t.update(bound_ms=b_ms, bound_by=b_by,
                         live_iterations=int(live[:n].sum()),
                         instances=n)
                cases[f"{label} {fill} {form}"] = t
                if label == "shared" and (form, fill) in (
                        ("block", "half"), ("walk", "unsat")):
                    plain_ms = cuda_ms(lambda: walksat.walksat_walk_plain(
                        assign, seeds=seeds, **tkw), reps=1, warmup=1)
                    name = ("walksat_block" if form == "block"
                            else "walksat_walk")
                    rows[name] = dict({
                        "name": name, "route": "cuda",
                        "source": "pdp_solver_tpu_torch/csrc/walksat.cu",
                        "replaces": "pdp_solver_tpu/ops/pallas_walksat.py:285",
                        "max_abs_err": 0.0, "plain_ms": plain_ms,
                        "library_ms": None, "blocks": len(seeds)}, **t)
                log(f"walksat {label} ({shape[0]} threads, staged vars "
                    f"{shape[1]}, edges {shape[2]}) {fill} {form} "
                    f"({len(seeds)} blocks): bit-exact; {timing_note(t)}, "
                    f"{int(live[:n].sum())} live iterations, bound "
                    f"{b_ms:.5f} ms ({b_by})")
    rows["walksat_walk"]["cases"] = cases
    return rows


def check_walksat_replicated(insts, torch, np):
    """The replicated walk (kernel 3 with R = 2: a launch a block, each
    CTA returning at once once the device's done flag is set) bit for bit
    against the plain walk with its replica stop (assignments as int32
    views, energies exactly), 25 blocks of K = 8 at eps 0.5, on the shared
    set and on a compacted batch (8 instances of 128 rows: padding rows
    and variables between the replicas), from a random fill (every
    instance unsat) and from a problem with most clauses inactive, where
    every instance has a solved replica before the last block. The
    shared set's random fill is then timed three ways, per call and per
    block, its bound counting each row's live iterations up to the stop.
    Returns the row "walksat_walk[replicas=2]"."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances, replicate_batch
    from pdp_solver_tpu_torch.ops import walksat
    from pdp_solver_tpu_torch.utils.bench_kernels import (
        WALK_SEEDS, timed, walk_inputs)
    K, R, seeds = 8, 2, WALK_SEEDS
    g = torch.Generator().manual_seed(19)
    row, cases = None, {}
    for label, sub in (("shared", insts), ("compacted", insts[:8])):
        b = replicate_batch(pack_instances(sub, device="cuda"), R)
        require(walksat.use_walksat_block(b), f"walksat replicated: {label}"
                " is not taken by the block rule")
        for fill in ("unsat", "easy"):
            assign, av, ac, em = walk_inputs(b, "unsat")
            if fill == "easy":
                ac = ac * (torch.rand(b.num_clauses, generator=g)
                           > 0.8).float().cuda()
                em = b.edge_mask * av[b.edge_var] * ac[b.edge_clause]
            kw = dict(batch=b, active_vars=av, active_clauses=ac, em=em,
                      K=K, eps=0.5)
            a, stop = assign, None
            for j, seed in enumerate(seeds):
                a, e = walksat.walksat_block_plain(a, seed=seed, **kw)
                if walksat.replicas_done(b, e, R) > 0:
                    stop = j
                    break
            n0 = walksat.walksat_walk.launches
            got_a, got_e = walksat.walksat_walk(assign, seeds=seeds,
                                                replicas=R, **kw)
            torch.cuda.synchronize()
            require(walksat.walksat_walk.launches - n0 == len(seeds),
                    "walksat replicated: not one launch a block")
            same = (np.array_equal(got_a.cpu().numpy().view(np.int32),
                                   a.cpu().numpy().view(np.int32))
                    and torch.equal(got_e, e))
            require(same, f"walksat replicated ({label}, {fill}): not "
                    f"bit-exact, {int((got_a != a).sum())} variables differ")
            if fill == "easy":
                require(stop is not None and stop < len(seeds) - 1,
                        f"walksat replicated ({label}): the walk never "
                        "stopped early")
            n_run = len(seeds) if stop is None else stop + 1
            log(f"walksat replicated {label} {fill} (R = {R}, "
                f"{b.num_instances} rows launched): bit-exact, every "
                f"instance solved by a replica after "
                f"{'no' if stop is None else stop + 1} of {len(seeds)} "
                "blocks")
            if (label, fill) != ("shared", "unsat"):
                continue
            t = timed(lambda: walksat.walksat_walk(assign, seeds=seeds,
                                                   replicas=R, **kw))
            _, live, ops = walk_steps(walksat, b, assign, dict(
                batch=b, active_vars=av, active_clauses=ac, em=em),
                seeds[:n_run], K, 0.5)
            b_ms, b_by = walk_bound(b, ops, len(seeds))
            plain_ms = cuda_ms(lambda: walksat.walksat_walk_plain(
                assign, seeds=seeds, replicas=R, **kw), reps=1, warmup=1)
            row = dict({
                "name": "walksat_walk[replicas=2]", "route": "cuda",
                "source": "pdp_solver_tpu_torch/csrc/walksat.cu",
                "replaces": "pdp_solver_tpu/ops/pallas_walksat.py:285",
                "max_abs_err": 0.0, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "blocks": len(seeds), "launches_per_call": len(seeds),
                "blocks_run": n_run, "live_iterations": int(live.sum())},
                **t)
            row["ms_per_block"] = row["ms"] / len(seeds)
            log(f"walksat replicated shared unsat ({len(seeds)} blocks, "
                f"{len(seeds)} launches): {timing_note(t)}, "
                f"{row['ms_per_block']:.4f} ms a block, plain "
                f"{plain_ms:.2f} ms, bound {b_ms:.5f} ms ({b_by})")
            cases[f"{label} {fill}"] = t
    row["cases"] = cases
    return {"walksat_walk[replicas=2]": row}


def check_reduce2d(batch, torch):
    """Kernels 6 and 7 at the np-nd-np shapes against their plain versions,
    timed beside them, the one-call library version and the bound."""
    from pdp_solver_tpu_torch.ops import reduce2d
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    E, V, d = batch.num_edges, batch.num_vars, HIDDEN_AGG
    e = batch.num_real_edges
    g = torch.Generator().manual_seed(17)
    x = torch.randn(E, d, generator=g).cuda()
    nodes = torch.randn(V, d, generator=g).cuda()
    ev = batch.edge_var
    rows = {}

    def seg():
        return reduce2d.segment_sum_2d(x, ev, V, e, batch.var_ptr,
                                       batch.var_perm,
                                       max_degree=batch.var_max_degree)

    def seg_plain():
        return reduce2d.segment_sum_2d_plain(x, ev, V, e)

    got, ref = seg(), seg_plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    require(bool(torch.isfinite(got).all()), "segment_sum_2d: non-finite")
    require(torch.allclose(got, ref, **REDUCE2D_TOL),
            f"segment_sum_2d: max abs err {err} beyond rtol "
            f"{REDUCE2D_TOL['rtol']} / atol {REDUCE2D_TOL['atol']}")
    out = torch.zeros(V, d, device="cuda")
    x_real, ev_real = x[:e], ev[:e]
    lib = timed(lambda: out.index_add_(0, ev_real, x_real))
    # rows of the real edges, the permutation and offsets read once, the
    # sums written once; one add per element read
    b_ms, b_by = bound_ms((e * d + e + V + 1 + V * d) * 4, e * d)
    rows["segment_sum_2d"] = dict(
        timed(seg), name="segment_sum_2d", route="cuda",
        source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
        replaces=f"{PALLAS_2D}:109", max_abs_err=err,
        plain_ms=cuda_ms(seg_plain, reps=20), bound_ms=b_ms, bound_by=b_by,
        library_ms=lib["ms"], library_host_us=lib["host_us"],
        library_device_us=lib["device_us"],
        library="index_add_ over the real edges")

    # the path's ids are i32 (edge_var32); i64 ids give the same bits
    ev32 = batch.edge_var32
    for ids in (ev32, ev):
        for minus in (None, x):
            got = reduce2d.gather_2d(nodes, ids, minus)
            ref = reduce2d.gather_2d_plain(nodes, ev, minus)
            torch.cuda.synchronize()
            require(torch.equal(got, ref), f"gather_2d (minus "
                    f"{minus is not None}, {ids.dtype}): not bit-exact, max "
                    f"abs err {float((got - ref).abs().max())}")
    # the path's form subtracts each edge's own row (aggregate minus self):
    # the subtrahend and the output, the node rows and i32 ids
    b_ms, b_by = bound_ms((E * d + E + V * d + E * d) * 4, E * d)
    b_plain, _ = bound_ms((E + V * d + E * d) * 4, 0)
    kern = timed(lambda: reduce2d.gather_2d(nodes, ev32, x))
    plain_gather = timed(lambda: reduce2d.gather_2d(nodes, ev32))
    lib = timed(lambda: nodes.index_select(0, ev))
    rows["gather_2d"] = dict(
        kern, name="gather_2d", route="cuda",
        source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
        replaces=f"{PALLAS_2D}:120", max_abs_err=0.0,
        plain_ms=cuda_ms(lambda: reduce2d.gather_2d_plain(nodes, ev, x),
                         reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_select (the gather without the subtract, i64 ids)",
        without_minus=dict(plain_gather, bound_ms=b_plain),
        ms_i64_ids=cuda_ms(lambda: reduce2d.gather_2d(nodes, ev, x),
                           reps=50),
        without_minus_ms_i64_ids=cuda_ms(
            lambda: reduce2d.gather_2d(nodes, ev), reps=50))
    for r in rows.values():
        log(f"kernel {r['name']}: ok, max abs err {r['max_abs_err']:.3g}, "
            f"{timing_note(r)} (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, host {r['library_host_us']:.1f} us, "
            f"device {r['library_device_us']:.2f} us; bound "
            f"{r['bound_ms']:.5f} ms)")
    log(f"kernel gather_2d without the subtract: "
        f"{timing_note(plain_gather)}, bound {b_plain:.5f} ms")
    return rows


def check_reduce2d_bf16(batch, compacted, torch):
    """Kernels 6 and 7 on bf16 rows (compute_dtype="bfloat16") at d = 50,
    on the shared set and a compacted batch, in the only forms either
    package takes (JAX's f32 edge mask makes its sums f32): bf16 rows into
    f32 sums over both CSRs to REDUCE2D_TOL of the plain version, and f32
    sums minus bf16 rows bit for bit with i32 and i64 ids; no f32 launch
    counted. Timed at the shared set beside the plain versions, the bf16
    PyTorch calls (index_add_ on bf16, which rounds at every add: a time
    only) and the bound."""
    from pdp_solver_tpu_torch.ops import reduce2d
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    d, bf16 = HIDDEN_AGG, torch.bfloat16
    f32_launches = (reduce2d.segment_sum_2d.launches,
                    reduce2d.gather_2d.launches)
    errs = {}
    for label, b in (("shared", batch), ("compacted", compacted)):
        g = torch.Generator().manual_seed(19)
        x = torch.randn(b.num_edges, d, generator=g).cuda().to(bf16)
        nodes = torch.randn(b.num_vars, d, generator=g).cuda()
        e = b.num_real_edges
        for side, ids, n, ptr, perm, md in (
                ("var", b.edge_var, b.num_vars, b.var_ptr, b.var_perm,
                 b.var_max_degree),
                ("clause", b.edge_clause, b.num_clauses, b.clause_ptr,
                 None, b.clause_max_degree)):
            got = reduce2d.segment_sum_2d(x, ids, n, e, ptr, perm,
                                          max_degree=md)
            ref = reduce2d.segment_sum_2d_plain(x, ids, n, e)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            errs[f"{label}_{side}"] = err
            require(got.dtype == torch.float32
                    and torch.allclose(got, ref, **REDUCE2D_TOL),
                    f"segment_sum_2d[bf16] {label} {side}: max abs err "
                    f"{err}")
        for ids in (b.edge_var32, b.edge_var):
            got = reduce2d.gather_2d(nodes, ids, x)
            ref = reduce2d.gather_2d_plain(nodes, b.edge_var, x)
            torch.cuda.synchronize()
            require(got.dtype == torch.float32 and torch.equal(got, ref),
                    f"gather_2d[bf16] {label} ({ids.dtype}): not bit-exact")
    require((reduce2d.segment_sum_2d.launches,
             reduce2d.gather_2d.launches) == f32_launches,
            "a bf16 call launched an f32 kernel")

    E, V, e = batch.num_edges, batch.num_vars, batch.num_real_edges
    F = batch.num_clauses
    g = torch.Generator().manual_seed(19)
    x = torch.randn(E, d, generator=g).cuda().to(bf16)
    nodes = torch.randn(V, d, generator=g).cuda()
    ev, ev32 = batch.edge_var, batch.edge_var32
    rows = {}

    def seg():
        return reduce2d.segment_sum_2d(x, ev, V, e, batch.var_ptr,
                                       batch.var_perm,
                                       max_degree=batch.var_max_degree)

    out = torch.zeros(V, d, device="cuda", dtype=bf16)
    x_real, ev_real = x[:e], ev[:e]
    lib = timed(lambda: out.index_add_(0, ev_real, x_real))
    # bf16 rows of the real edges, the permutation and offsets read once,
    # the f32 sums written once; one add per element read
    b_ms, b_by = bound_ms(e * d * 2 + (e + V + 1) * 4 + V * d * 4, e * d)
    b_clause, _ = bound_ms(e * d * 2 + (F + 1) * 4 + F * d * 4, e * d)
    rows["segment_sum_2d[bf16]"] = dict(
        timed(seg), name="segment_sum_2d[bf16]", route="cuda",
        source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
        replaces=f"{PALLAS_2D}:109", max_abs_err=max(errs.values()),
        max_abs_err_by_case=errs,
        plain_ms=cuda_ms(lambda: reduce2d.segment_sum_2d_plain(
            x, ev, V, e), reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_add_ on bf16 over the real edges (bf16 sums "
                "rounded at every add: a time, not the same function)",
        form="bf16 rows, f32 sums, var CSR",
        clause_csr=dict(timed(lambda: reduce2d.segment_sum_2d(
            x, batch.edge_clause, F, e, batch.clause_ptr,
            max_degree=batch.clause_max_degree)), bound_ms=b_clause))
    # f32 sums minus the bf16 rows, f32 out, i32 ids: the subtrahend, the
    # ids, the node rows read once and the output written once
    b_ms, b_by = bound_ms(E * d * 2 + E * 4 + V * d * 4 + E * d * 4, E * d)
    nb = nodes.to(bf16)
    lib = timed(lambda: nb.index_select(0, ev))
    rows["gather_2d[bf16]"] = dict(
        timed(lambda: reduce2d.gather_2d(nodes, ev32, x)),
        name="gather_2d[bf16]", route="cuda",
        source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
        replaces=f"{PALLAS_2D}:120", max_abs_err=0.0,
        plain_ms=cuda_ms(lambda: reduce2d.gather_2d_plain(nodes, ev, x),
                         reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_select on bf16 nodes (the gather without the "
                "subtract, i64 ids)",
        form="f32 sums minus bf16 rows, f32 out, i32 ids")
    for r in rows.values():
        log(f"kernel {r['name']} ({r['form']}): ok, max abs err "
            f"{r['max_abs_err']:.3g}, {timing_note(r)} (plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"host {r['library_host_us']:.1f} us, device "
            f"{r['library_device_us']:.2f} us; bound {r['bound_ms']:.5f} ms)")
    c = rows["segment_sum_2d[bf16]"]["clause_csr"]
    log(f"kernel segment_sum_2d[bf16] over the clause CSR: "
        f"{timing_note(c)}, bound {c['bound_ms']:.5f} ms")
    return rows


def sum2d_bound(e, d, esize, n, perm):
    """Kernel 6's bound: the real rows (esize bytes an element), the
    permutation and offsets read once, the f32 sums written once; one add
    an element read."""
    return bound_ms(e * d * esize + ((e if perm else 0) + n + 1) * 4
                    + n * d * 4, e * d)


def check_sum2d_walk(shapes, torch):
    """Kernel 6 (csrc/reduce2d.cu) on f32 and bf16 rows of d = 50 over
    the var and the clause CSR of each batch in `shapes` ({label:
    batch}), with the batch's largest degree as the path passes it: the
    same bits on two calls, the bits of its order emulated in PyTorch
    (ops/reduce2d.py walk_order_sum_2d), and within REDUCE2D_TOL of the
    float64 index_add_ of the real rows. The hub's forms (its 63,488-edge
    variable cut into pieces) are timed beside index_add_ and their bound.
    Returns {case: numbers}."""
    from pdp_solver_tpu_torch.ops import reduce2d
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    d, cases = HIDDEN_AGG, {}
    for label, b in shapes.items():
        g = torch.Generator().manual_seed(31)
        x32 = torch.randn(b.num_edges, d, generator=g).cuda()
        e = b.num_real_edges
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for side, ids, n, ptr, perm, md in (
                    ("var", b.edge_var, b.num_vars, b.var_ptr, b.var_perm,
                     b.var_max_degree),
                    ("clause", b.edge_clause32, b.num_clauses,
                     b.clause_ptr, None, b.clause_max_degree)):
                name = (f"segment_sum_2d[{label} {side} "
                        f"{str(dtype)[6:]}]")

                def call():
                    return reduce2d.segment_sum_2d(x, ids, n, e, ptr, perm,
                                                   max_degree=md)
                got, again = call(), call()
                emu = reduce2d.walk_order_sum_2d(x, ptr, perm)
                ref64 = torch.zeros(n, d, dtype=torch.float64,
                                    device="cuda").index_add_(
                    0, ids[:e].long(), x[:e].double())
                torch.cuda.synchronize()
                err = float((got.double() - ref64).abs().max())
                require(torch.equal(got, again), f"{name}: two calls differ")
                require(torch.equal(got, emu), f"{name}: not the order of "
                        f"walk_order_sum_2d (max abs diff "
                        f"{float((got - emu).abs().max()):.3g})")
                require(torch.allclose(got.double(), ref64, **REDUCE2D_TOL),
                        f"{name}: max abs err {err} against float64")
                case = dict(max_abs_err64=err, max_degree=md, edges=e)
                if label == "hub" and side == "var":
                    out = torch.zeros(n, d, device="cuda", dtype=dtype)
                    x_real, ids_real = x[:e], ids[:e]
                    lib = timed(lambda: out.index_add_(0, ids_real, x_real))
                    b_ms, b_by = sum2d_bound(e, d, x.element_size(), n,
                                             True)
                    case.update(timed(call), bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib["ms"],
                                library_device_us=lib["device_us"])
                    log(f"kernel {name}: {timing_note(case)} (index_add_ "
                        f"{timing_note(lib)}; bound {b_ms:.5f} ms, {b_by})")
                case.pop("device_kernels", None)
                cases[name[len("segment_sum_2d["):-1]] = case
    log(f"kernel segment_sum_2d: {len(cases)} forms bit-equal to "
        f"walk_order_sum_2d, twice the same bits, within rtol "
        f"{REDUCE2D_TOL['rtol']} / atol {REDUCE2D_TOL['atol']} of float64 "
        f"(max abs err {max(c['max_abs_err64'] for c in cases.values()):.3g})"
        f" on {', '.join(shapes)}")
    return cases


def ragged_batch(np, seed=5, count=128, n=100, m=900):
    """A batch of the shared set's size whose clauses have mixed widths
    (2-6, mean 4): no uniform width, so every clause-direction sum walks
    the clause CSR; its variable ids fail the TPU window invariant's
    uniform layout."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    rng = np.random.default_rng(seed)
    insts = []
    for _ in range(count):
        widths = rng.integers(2, 7, size=m)
        ev = rng.integers(0, n, size=int(widths.sum())).astype(np.int32)
        ec = np.repeat(np.arange(m, dtype=np.int32), widths)
        signs = (2.0 * rng.integers(0, 2, size=ev.shape[0]) - 1.0).astype(
            np.float32)
        insts.append((n, m, np.stack([ev, ec]), signs, -1.0))
    return pack_instances(insts, device="cuda")


def _check_sum(torch, name, got, ref, exact):
    require(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
            f"{tuple(ref.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    err = float((got - ref).abs().max())
    if exact:
        require(torch.equal(got, ref), f"{name}: not exact ({err})")
    else:
        require(torch.allclose(got, ref, **FLOAT_TOL),
                f"{name}: max abs err {err} beyond rtol "
                f"{FLOAT_TOL['rtol']} / atol {FLOAT_TOL['atol']}")
    return err


def walk_reference(torch, x, ids, ptr=None, perm=None, n=None):
    """The sums of x f32[C, E] in the group walk's order, emulated in
    PyTorch (ops/reduce.py walk_order_sum): over the CSR (ptr, perm), or
    over the runs of sorted ids when ptr is None."""
    from pdp_solver_tpu_torch.ops import _build, reduce
    if ptr is not None:
        lo, hi = reduce.csr_bounds(ptr)
        slot_edge = None if perm is None else perm.long()
        n_slots = int(ptr[-1])
    else:
        lo, hi = reduce.sorted_bounds(ids, n)
        n_slots, slot_edge = ids.shape[0], None
    gw = _build.group_width(n_slots, lo.shape[0])
    return reduce.walk_order_sum(x, lo, hi, slot_edge, gw)


def check_walk_sum(torch, name, call, x, ids, **csr):
    """A group-walk sum: the same bits on two calls and the bits of the
    walk's order emulated in PyTorch."""
    got, again = call(), call()
    ref = walk_reference(torch, x, ids, **csr)
    torch.cuda.synchronize()
    require(torch.equal(got, again), f"{name}: two calls differ")
    require(torch.equal(got, ref), f"{name}: not the walk's order (max "
            f"abs diff {float((got - ref).abs().max()):.3g})")


def check_reduce(batch, torch, np):
    """Kernel 4 (csrc/reduce.cu) at the shared-set shapes, on a ragged
    batch (kernel 5's function) and over sorted ids (kernel 8's)."""
    from pdp_solver_tpu_torch.ops import reduce, reduce2d
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    E, V, F = batch.num_edges, batch.num_vars, batch.num_clauses
    e = batch.num_real_edges
    g = torch.Generator().manual_seed(23)
    rows = {}

    # signed integer-valued columns must sum exactly; float columns are
    # non-negative, as the path's are (the smooth-max numerator and
    # denominator), so rtol bounds the atomic-order error of the plain
    # index_add_
    def cols_of(C, E_, integer):
        return [(torch.randint(-3, 4, (E_,), generator=g).float() if integer
                 else torch.rand(E_, generator=g)).cuda() for _ in range(C)]

    def csr_bytes(C, n, e_, perm):
        return (C * e_ + (e_ if perm else 0) + n + 1 + C * n) * 4

    # the path's shapes: [E, 2] rows over the var CSR (the convergence
    # test's smooth-max), one column over the var CSR (the predictor), and
    # one column over the clause CSR
    shapes = {}
    for label, C, ids, n, ptr, perm, md in (
            ("var C=2", 2, batch.edge_var, V, batch.var_ptr, batch.var_perm,
             batch.var_max_degree),
            ("var C=1", 1, batch.edge_var, V, batch.var_ptr, batch.var_perm,
             batch.var_max_degree),
            ("clause C=1", 1, batch.edge_clause, F, batch.clause_ptr,
             None, batch.clause_max_degree)):
        err = 0.0
        for integer in (True, False):
            cols = cols_of(C, E, integer)
            ref = reduce.segment_sum_cols_plain(cols, ids, n, e)
            got = reduce.segment_sum_cols(cols, ids, n, e, ptr, perm,
                                          max_degree=md)
            torch.cuda.synchronize()
            err = max(err, _check_sum(torch, f"segment_sum_cols[{label}]",
                                      got, ref, integer))
        check_walk_sum(torch, f"segment_sum_cols[{label}]",
                       lambda: reduce.segment_sum_cols(
                           cols, ids, n, e, ptr, perm, max_degree=md),
                       torch.stack(cols), ids, ptr=ptr, perm=perm)
        # the same bits when the launch does not know the largest degree
        # (its anchored blocks then look for heavy nodes and find none)
        require(torch.equal(got, reduce.segment_sum_cols(
            cols, ids, n, e, ptr, perm)), f"segment_sum_cols[{label}]: "
            "other bits without max_degree")
        x = torch.stack(cols, 1).contiguous()
        got = reduce.segment_sum(x, ids, n, e, ptr, perm, max_degree=md)
        torch.cuda.synchronize()
        require(torch.equal(got.reshape(n, C).T, reduce.segment_sum_cols(
            cols, ids, n, e, ptr, perm)), f"segment_sum[{label}]: [E, C] "
            "and column forms differ")
        xs = torch.stack([c[:e] for c in cols])
        out = torch.zeros(C, n, device="cuda")
        ids_real = ids[:e]
        b_ms, b_by = bound_ms(csr_bytes(C, n, e, perm is not None), C * e)
        kern = timed(lambda: reduce.segment_sum(
            x, ids, n, e, ptr, perm, max_degree=md) if C > 1
            else reduce.segment_sum_cols(cols, ids, n, e, ptr, perm,
                                         max_degree=md))
        lib = timed(lambda: out.index_add_(1, ids_real, xs))
        shapes[label] = dict(
            kern, max_abs_err=err, twice_equal=True, walk_order_bits=True,
            plain_ms=cuda_ms(lambda: reduce.segment_sum_cols_plain(
                cols, ids, n, e), reps=20),
            library_ms=lib["ms"], library_host_us=lib["host_us"],
            library_device_us=lib["device_us"],
            kernel6_ms=cuda_ms(lambda: reduce2d.segment_sum_2d(
                x, ids, n, e, ptr, perm), reps=50),
            bound_ms=b_ms, bound_by=b_by)
        log(f"kernel segment_sum_cols [{label}]: ok, max abs err {err:.3g}, "
            f"twice the same bits, the walk's order; {timing_note(kern)} "
            f"(plain {shapes[label]['plain_ms']:.4f}, index_add_ "
            f"{timing_note(lib)}, kernel 6 "
            f"{shapes[label]['kernel6_ms']:.4f}, bound {b_ms:.5f} ms)")
    main = shapes["var C=2"]
    rows["segment_sum_cols"] = dict(
        {"name": "segment_sum_cols", "route": "cuda", "source": REDUCE_CU,
         "replaces": "pdp_solver_tpu/ops/pallas_reduce.py:224",
         "library": "index_add_ of the stacked real edges", "shapes": shapes},
        **{k: main[k] for k in ("max_abs_err", "ms", "host_us", "device_us",
                                "plain_ms", "library_ms", "library_host_us",
                                "library_device_us", "bound_ms",
                                "bound_by")})

    # kernel 5's function: a batch that fails the window invariant
    rb = ragged_batch(np)
    require(rb.clause_width == 0, "the ragged batch has a uniform width")
    Er, er = rb.num_edges, rb.num_real_edges
    err = 0.0
    for integer in (True, False):
        cols = cols_of(3, Er, integer)
        for ids, n, ptr, perm, md in (
                (rb.edge_var, rb.num_vars, rb.var_ptr, rb.var_perm,
                 rb.var_max_degree),
                (rb.edge_clause, rb.num_clauses, rb.clause_ptr, None,
                 rb.clause_max_degree)):
            ref = reduce.segment_sum_cols_plain(cols, ids, n, er)
            got = reduce.segment_sum_cols(cols, ids, n, er, ptr, perm,
                                          max_degree=md)
            torch.cuda.synchronize()
            err = max(err, _check_sum(torch, "segment_sum_cols[ragged]",
                                      got, ref, integer))
            check_walk_sum(torch, "segment_sum_cols[ragged]",
                           lambda: reduce.segment_sum_cols(
                               cols, ids, n, er, ptr, perm, max_degree=md),
                           torch.stack(cols), ids, ptr=ptr, perm=perm)
    xs = torch.stack([c[:er] for c in cols])
    out = torch.zeros(3, rb.num_vars, device="cuda")
    ids_real = rb.edge_var[:er]
    b_ms, b_by = bound_ms(csr_bytes(3, rb.num_vars, er, True), 3 * er)
    args = (rb.edge_var, rb.num_vars, er, rb.var_ptr, rb.var_perm)
    kern = timed(lambda: reduce.segment_sum_cols(
        cols, *args, max_degree=rb.var_max_degree))
    lib = timed(lambda: out.index_add_(1, ids_real, xs))
    rows["segment_sum_cols[ragged]"] = dict(
        kern, name="segment_sum_cols[ragged]", route="cuda",
        source=REDUCE_CU,
        replaces="pdp_solver_tpu/ops/pallas_reduce.py:209",
        max_abs_err=err, twice_equal=True, walk_order_bits=True,
        plain_ms=cuda_ms(lambda: reduce.segment_sum_cols_plain(
            cols, rb.edge_var, rb.num_vars, er), reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_add_ of the stacked real edges",
        note=f"C = 3 over the var CSR of a batch of mixed clause widths "
             f"(E = {Er}, {er} real)")
    del rb

    # kernel 8's function: one column over sorted ids, the real edges'
    # clause ids (the padding's 63,488-edge run is check_walk's case)
    ids = batch.edge_clause[:e]
    x = torch.randint(-3, 4, (e,), generator=g).float().cuda()
    got = reduce.sorted_segment_sum(x, ids, F)
    ref = reduce.sorted_segment_sum_plain(x, ids, F)
    torch.cuda.synchronize()
    _check_sum(torch, "sorted_segment_sum", got, ref, True)
    xf = torch.rand(e, generator=g).cuda()
    err = _check_sum(torch, "sorted_segment_sum",
                     reduce.sorted_segment_sum(xf, ids, F),
                     reduce.sorted_segment_sum_plain(xf, ids, F), False)
    check_walk_sum(torch, "sorted_segment_sum",
                   lambda: reduce.sorted_segment_sum(xf, ids, F)[None],
                   xf[None], ids, n=F)
    out = torch.zeros(F, device="cuda")
    b_ms, b_by = bound_ms((e + 2 * e + F) * 4, e)   # x, i64 ids, sums
    kern = timed(lambda: reduce.sorted_segment_sum(xf, ids, F))
    lib = timed(lambda: out.index_add_(0, ids, xf))
    rows["sorted_segment_sum"] = dict(
        kern, name="sorted_segment_sum", route="cuda", source=REDUCE_CU,
        replaces="pdp_solver_tpu/ops/pallas_segment.py:120",
        max_abs_err=err, twice_equal=True, walk_order_bits=True,
        plain_ms=cuda_ms(lambda: reduce.sorted_segment_sum_plain(
            xf, ids, F), reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_add_",
        note="kernel checks only: on no solve path, in the JAX package "
             "either; its CUDA kernel is segment_sum_cols, whose launches "
             "on the reinforce path `launches` counts")
    for name in ("segment_sum_cols[ragged]", "sorted_segment_sum"):
        r = rows[name]
        log(f"kernel {name}: ok, max abs err {r['max_abs_err']:.3g}, twice "
            f"the same bits, the walk's order; {timing_note(r)} (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} ms, host "
            f"{r['library_host_us']:.1f} us, device "
            f"{r['library_device_us']:.2f} us; bound {r['bound_ms']:.5f} ms)")
    return rows


def check_chained_walk(fn, b, label, torch):
    """One chained functor on a compacted or high-degree batch: against
    its plain version (exact for the integer functors; at high degree the
    SP sums against float64), the same bits twice, the walk's order, and
    timed."""
    from pdp_solver_tpu_torch.ops import fused
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    name = f"chained_edge_pass[{fn.name}] {label}"
    ins = fn_inputs(fn, b, seed=47)
    got = fused.chained_edge_pass(fn, b, ins)
    again = fused.chained_edge_pass(fn, b, ins)
    ref = list(fused.chained_edge_pass_plain(fn, b, ins))
    exact = fn.name in EXACT_FNS
    if label == "high_degree" and fn.n_vred and not exact:
        ref[1] = fused.chained_edge_pass_plain(
            fn, b, [t.double() for t in ins])[1].float()
    torch.cuda.synchronize()
    err = 0.0
    flags = EXACT_OUTPUTS.get(fn.name, ())
    for i, (o, a, r) in enumerate(zip(_flat(got), _flat(again),
                                      _flat(ref))):
        err = max(err, _check_sum(torch, name, o, r, exact or i in flags))
        require(torch.equal(o, a), f"{name}: two calls differ")
    if fn.n_vred:
        emu = fused.chained_vred_walk_order(fn, b, ins)
        torch.cuda.synchronize()
        require(torch.equal(got[1], emu), f"{name}: not the walk's order")
    kern = timed(lambda: fused.chained_edge_pass(fn, b, ins))
    order = ", the walk's order" if fn.n_vred else ""
    log(f"{name}: ok, max abs err {err:.3g}, twice the same bits{order}; "
        f"{timing_note(kern)}")
    return dict(kern, max_abs_err=err, edges=b.num_edges,
                max_degree=b.var_max_degree)


def check_walk(insts, torch, np):
    """The redesigned forms (kernel 4 over the var and clause CSRs,
    kernel 8, kernel 1's var side and `ae`, kernel 2's five functors) at a
    compacted shape, the 8 instances that a 32,768-edge bucket holds, and
    at high degree: a var CSR with one 63,488-edge node, and kernel 8 over
    all E edges of the shared set, whose last run holds the 63,488 padding
    edges; kernel 7 at the compacted shape. Each is
    checked (exact on integer columns, rtol 1e-5 / atol 1e-6 on floats,
    the same bits twice, the walk's order where it is a plain sum) and
    timed beside its PyTorch call. At high degree the float sums are held
    against the plain version taken in float64: a float32 index_add_ of
    63,488 terms in atomic order is itself ~1e-5 off, the walk's
    tree ~1e-6. Returns {row: {case: numbers}}."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import fused, reduce
    from pdp_solver_tpu_torch.utils.bench_kernels import hub_batch, timed
    g = torch.Generator().manual_seed(29)

    def plain64(cols, ids, n, e):
        out = torch.zeros((len(cols), n), dtype=torch.float64, device="cuda")
        return out.index_add_(1, ids[:e], torch.stack(
            [c[:e].double() for c in cols])).float()

    cases = {"segment_sum_cols": {}, "sorted_segment_sum": {},
             "smax_scorer": {}, "scorer": {}, "ae": {}}
    cases.update({fn.name: {} for fn in fused.CHAINED_FNS})
    compacted = pack_instances(insts[:8], device="cuda")
    require(compacted.num_edges == 32768, "the compacted batch has "
            f"{compacted.num_edges} edges")
    hub = hub_batch()
    for label, b in (("compacted", compacted), ("high_degree", hub)):
        E, e = b.num_edges, b.num_real_edges
        for form, C, ids, n, ptr, perm, md in (
                ("var C=2", 2, b.edge_var, b.num_vars, b.var_ptr,
                 b.var_perm, b.var_max_degree),
                ("var C=1", 1, b.edge_var, b.num_vars, b.var_ptr,
                 b.var_perm, b.var_max_degree),
                ("clause C=1", 1, b.edge_clause, b.num_clauses,
                 b.clause_ptr, None, b.clause_max_degree)):
            if label == "high_degree" and form.startswith("clause"):
                continue
            name = f"segment_sum_cols[{label} {form}]"
            icols = [torch.randint(-3, 4, (E,), generator=g).float().cuda()
                     for _ in range(C)]
            _check_sum(torch, name, reduce.segment_sum_cols(
                icols, ids, n, e, ptr, perm, max_degree=md),
                reduce.segment_sum_cols_plain(icols, ids, n, e), True)
            cols = [torch.rand(E, generator=g).cuda() for _ in range(C)]
            plain = (plain64 if label == "high_degree"
                     else reduce.segment_sum_cols_plain)
            err = _check_sum(torch, name, reduce.segment_sum_cols(
                cols, ids, n, e, ptr, perm, max_degree=md),
                plain(cols, ids, n, e), False)
            check_walk_sum(torch, name, lambda: reduce.segment_sum_cols(
                cols, ids, n, e, ptr, perm, max_degree=md),
                torch.stack(cols), ids, ptr=ptr, perm=perm)
            x = torch.stack(cols, 1).contiguous()
            xs = torch.stack([c[:e] for c in cols])
            out = torch.zeros(C, n, device="cuda")
            kern = timed(lambda: reduce.segment_sum(
                x, ids, n, e, ptr, perm, max_degree=md) if C > 1
                else reduce.segment_sum_cols(cols, ids, n, e, ptr, perm,
                                             max_degree=md))
            lib = timed(lambda: out.index_add_(1, ids[:e], xs))
            cases["segment_sum_cols"][f"{label} {form}"] = dict(
                kern, max_abs_err=err, edges=E, max_degree=int(
                    (ptr[1:] - ptr[:-1]).max()),
                library_ms=lib["ms"], library_host_us=lib["host_us"],
                library_device_us=lib["device_us"])
            log(f"{name}: ok, twice the same bits, the walk's order; "
                f"{timing_note(kern)} (index_add_ {timing_note(lib)})")
        for fn in (fused.SMAX_SCORER, fused.SCORER):
            name = f"fused_edge_pass[{fn.name}] {label}"
            ins = fn_inputs(fn, b, seed=41)
            if label == "high_degree":
                terms, _ = fn.plain([x.double() for x in ins], b.edge_var,
                                    b.edge_clause, 0.0)
                ref = plain64(terms, b.edge_var, b.num_vars, e)
            else:
                ref, _ = fused.fused_edge_pass_plain(fn, b, ins)
            got, _ = fused.fused_edge_pass(fn, b, ins)
            again, _ = fused.fused_edge_pass(fn, b, ins)
            torch.cuda.synchronize()
            err = _check_sum(torch, name, got, ref, False)
            require(torch.equal(got, again), f"{name}: two calls differ")
            kern = timed(lambda: fused.fused_edge_pass(fn, b, ins))
            cases[fn.name][label] = dict(kern, max_abs_err=err, edges=E)
            log(f"{name}: ok, max abs err {err:.3g}, twice the same bits; "
                f"{timing_note(kern)}")
        for fn in fused.CHAINED_FNS:
            cases[fn.name][label] = check_chained_walk(fn, b, label, torch)
    # kernel 7 at the compacted shape, the path's form (i32 ids, minus)
    from pdp_solver_tpu_torch.ops import reduce2d
    b = compacted
    nodes = torch.randn(b.num_vars, HIDDEN_AGG, generator=g).cuda()
    x = torch.randn(b.num_edges, HIDDEN_AGG, generator=g).cuda()
    require(torch.equal(reduce2d.gather_2d(nodes, b.edge_var32, x),
                        reduce2d.gather_2d_plain(nodes, b.edge_var, x)),
            "gather_2d (compacted): not bit-exact")
    kern = timed(lambda: reduce2d.gather_2d(nodes, b.edge_var32, x))
    lib = timed(lambda: nodes.index_select(0, b.edge_var))
    cases["gather_2d"] = {"compacted": dict(
        kern, library_ms=lib["ms"], library_host_us=lib["host_us"],
        library_device_us=lib["device_us"], edges=b.num_edges)}
    log(f"gather_2d compacted: exact; {timing_note(kern)} (index_select "
        f"{timing_note(lib)})")
    # ae and kernel 8 at the compacted shape
    (abv,) = fn_inputs(fused.AE, b, seed=43)
    require(torch.equal(fused.fused_edge_pass(fused.AE, b, (abv,))[1][0],
                        abv[b.edge_var]), "ae (compacted): not exact")
    kern = timed(lambda: fused.fused_edge_pass(fused.AE, b, (abv,)))
    lib = timed(lambda: abv[b.edge_var])
    cases["ae"]["compacted"] = dict(
        kern, library_ms=lib["ms"], library_host_us=lib["host_us"],
        library_device_us=lib["device_us"], edges=b.num_edges)
    log(f"fused_edge_pass[ae] compacted: exact; {timing_note(kern)} "
        f"(index gather {timing_note(lib)})")
    full = pack_instances(insts, device="cuda")
    last = full.num_real_clauses - 1
    for label, ids, n in (
            ("compacted", b.edge_clause[:b.num_real_edges], b.num_clauses),
            ("high_degree", full.edge_clause, full.num_clauses)):
        name = f"sorted_segment_sum[{label}]"
        xi = torch.randint(-3, 4, ids.shape, generator=g).float().cuda()
        _check_sum(torch, name, reduce.sorted_segment_sum(xi, ids, n),
                   reduce.sorted_segment_sum_plain(xi, ids, n), True)
        xf = torch.rand(ids.shape, generator=g).cuda()
        ref = (plain64([xf], ids, n, ids.shape[0])[0]
               if label == "high_degree"
               else reduce.sorted_segment_sum_plain(xf, ids, n))
        err = _check_sum(torch, name, reduce.sorted_segment_sum(xf, ids, n),
                         ref, False)
        check_walk_sum(torch, name,
                       lambda: reduce.sorted_segment_sum(xf, ids, n)[None],
                       xf[None], ids, n=n)
        out = torch.zeros(n, device="cuda")
        kern = timed(lambda: reduce.sorted_segment_sum(xf, ids, n))
        lib = timed(lambda: out.index_add_(0, ids, xf))
        cases["sorted_segment_sum"][label] = dict(
            kern, max_abs_err=err, edges=int(ids.shape[0]),
            longest_run=int((ids == last).sum()) if label == "high_degree"
            else None, library_ms=lib["ms"], library_host_us=lib["host_us"],
            library_device_us=lib["device_us"])
        log(f"{name}: ok, twice the same bits, the walk's order; "
            f"{timing_note(kern)} (index_add_ {timing_note(lib)})")
    return cases


def sweep_inputs(batch, torch, seed, pi, login=False):
    """The sweep's columns; with login, u is handed over as log u (p-nd-np's
    adaptors)."""
    g = torch.Generator().manual_seed(seed)
    E = batch.num_edges

    def u(lo=0.0, hi=1.0):
        return (torch.rand(E, generator=g) * (hi - lo) + lo).cuda()

    v = torch.rand(E, 3, generator=g)
    v = (v / v.sum(1, keepdim=True)).cuda()
    u_like = u(0.01, 1.0)
    return dict(u_like=torch.log(u_like) if login else u_like,
                eta_in=u(0.0, 0.99),
                em=batch.edge_mask * (u() > 0.1).float(),
                mask=(u() > 0.2).float(), eta_state=u(), sign=batch.edge_sign,
                force=(torch.where(u() > 0.5, 1.0, -1.0) if pi
                       else torch.zeros(E, device="cuda")),
                v0=v[:, 0].contiguous(), v1=v[:, 1].contiguous(),
                v2=v[:, 2].contiguous())


def check_sp_sweep(batch, compacted, torch):
    """Kernel 9 against its plain version and, bit for bit, against the
    two launches it replaces (its variable sums take the chained pass's
    walk order), for pi = 0 (p-d-p), 0.01 (reinforce) and in its
    log-input form at pi = 0 (p-nd-np), at the shared-set shapes, on a
    compacted batch, on the hub batch (one 63,488-edge variable, cut
    in pieces over a cluster of 16 CTAs) and on the shared set and the
    compacted batch replicated twice (replica 0's padding inside the
    prefix, the mask 1 on padding edges as the solver's active-edge flag
    is). On the hub the plain version is
    taken in float64 and held at an absolute 5e-5 (a float32 sum of
    63,488 terms in any order is itself ~1e-5 off; a wrong sum is off by
    a whole term, ~1e-2 or more), beside the two launches' bits."""
    from pdp_solver_tpu_torch.fg.batch import replicate_batch
    from pdp_solver_tpu_torch.ops import fused, sp_sweep
    from pdp_solver_tpu_torch.utils.bench_kernels import hub_batch, timed
    E, V, F, B = (batch.num_edges, batch.num_vars, batch.num_clauses,
                  batch.batch_size)
    e = batch.num_real_edges
    shapes = (("shared", batch), ("compacted", compacted),
              ("high_degree", hub_batch()),
              ("shared_replicated", replicate_batch(batch, 2)),
              ("compacted_replicated", replicate_batch(compacted, 2)))
    per_case = {}
    for pi, login in ((0.0, False), (0.01, False), (0.0, True)):
        case = f"login, pi {pi}" if login else f"pi {pi}"
        for label, b in shapes:
            kw = sweep_inputs(b, torch, 31, pi, login)
            cols = tuple(kw.values())
            chain = fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN

            def one():
                return sp_sweep.sp_full_sweep(b, pi=pi, login=login, **kw)

            def two():
                _, pn, (eta,), _ = fused.chained_edge_pass(chain, b,
                                                           cols[:6])
                _, q = fused.fused_edge_pass(
                    fused.SP_PASS_C, b, (pn[0], pn[1]) + cols[1:4]
                    + cols[5:], scalar=pi)
                return (eta,) + tuple(q)

            def plain():
                return sp_sweep.sp_full_sweep_plain(b, cols, pi, login)

            got, twin = one(), two()
            if label != "high_degree":
                ref = plain()
                torch.cuda.synchronize()
                err = max(_check_sum(torch, "sp_full_sweep", a, r, False)
                          for a, r in zip(got, ref))
            else:
                # one sum of 63,488 log terms: the walk's float32 order
                # against the float64 plain version
                ref = sp_sweep.sp_full_sweep_plain(
                    b, tuple(c.double() for c in cols), pi, login)
                torch.cuda.synchronize()
                require(all(bool(torch.isfinite(a).all()) for a in got),
                        "sp_full_sweep (high_degree): non-finite")
                err = max(float((a.double() - r).abs().max())
                          for a, r in zip(got, ref))
                require(err <= 5e-5, f"sp_full_sweep ({case}, high_degree): "
                        f"max abs err {err:.3g} against float64 > 5e-5")
            bits = all(torch.equal(a, c) for a, c in zip(got, twin))
            require(bits, f"sp_full_sweep ({case}, {label}): not bit-equal "
                    "to its two launches")
            cluster = sp_sweep._plan(b).args.cluster
            if label == "shared":
                per_case[case] = dict(
                    timed(one), max_abs_err=err, bit_equal_two_launch=True,
                    cluster=cluster, plain_ms=cuda_ms(plain, reps=10),
                    two_launch_ms=cuda_ms(two, reps=50))
                r = per_case[case]
            else:
                r = per_case[case][label] = dict(
                    timed(one), max_abs_err=err, cluster=cluster,
                    two_launch_ms=cuda_ms(two, reps=50), edges=b.num_edges)
            log(f"kernel sp_full_sweep ({case}, {label}): ok, max abs err "
                f"{err:.3g} vs plain, bit-equal to the two launches, "
                f"clusters of {cluster}; {timing_note(r)} (two launches "
                f"{r['two_launch_ms']:.4f} ms)")
    # 10 edge columns in, 4 out; edge_var, var_perm, the padding edges'
    # clause ids and the CSR offsets read once
    nbytes = ((10 + 4 + 1) * E + e + (E - e) + (V + 1) + (F + 1)
              + 2 * (B + 1)) * 4
    rows = {}
    for name, chain, case in (
            ("sp_full_sweep", fused.SP_CHAIN, "pi 0.0"),
            ("sp_full_sweep[login]", fused.SP_CHAIN_LOGIN, "login, pi 0.0")):
        b_ms, b_by = bound_ms(nbytes, (chain.flops
                                       + fused.SP_PASS_C.flops) * E)
        main = per_case[case]
        cases = {k: v for k, v in per_case.items()
                 if k.startswith("login") == name.endswith("[login]")}
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "pdp_solver_tpu_torch/csrc/sp_sweep.cu",
            "replaces": "pdp_solver_tpu/ops/pallas_sp.py:166",
            "max_abs_err": max(max([r["max_abs_err"]] + [
                r[k]["max_abs_err"] for k in ("compacted", "shared_replicated",
                                              "compacted_replicated")])
                for r in cases.values()),
            "ms": main["ms"], "host_us": main["host_us"],
            "device_us": main["device_us"], "cluster": main["cluster"],
            "plain_ms": main["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "none exists; two_launch_ms times the two launches "
                       "it replaces",
            "two_launch_ms": main["two_launch_ms"], "cases": cases}
    return rows


def planted_like(insts, np, seed):
    """The instances with the same graphs and each a random assignment
    that satisfies it (a clause the assignment leaves unsatisfied gets the
    sign of its first literal flipped), and those assignments (0/1)."""
    rng = np.random.default_rng(seed)
    out, xs = [], []
    for n, m, gmap, signs, label in insts:
        x = rng.integers(0, 2, size=n)
        v, c = gmap[0], gmap[1]
        s = np.asarray(signs, np.float32).reshape(-1).copy()
        true = (s > 0) == (x[v] > 0)
        sat = np.bincount(c, weights=true, minlength=m) > 0
        _, first = np.unique(c, return_index=True)
        flip = first[~sat[c[first]]]
        s[flip] = -s[flip]
        out.append((n, m, gmap, s, label))
        xs.append(x.astype(np.float32))
    return out, xs


def check_verify(insts, torch, np):
    """Kernel 10 against its plain version and the split path it
    replaces, exactly on all four outputs: the shared set's graphs with
    planted signs, some variables and clauses inactive, every fourth
    instance already stopped, and a prediction that solves the even
    instances (so some stopped instances are solved, and some active ones
    are frozen by this verification); the same for a compacted batch (the
    first 8 of them) and for the hub instance (one 63,488-edge variable).
    Timed three ways beside the split path."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import verify
    from pdp_solver_tpu_torch.problem.state import (
        edge_masks_pair, init_problem_state)
    from pdp_solver_tpu_torch.train.loss import cnf_evaluate
    from pdp_solver_tpu_torch.utils.bench_kernels import hub_instance, timed
    cases = {}
    for label, source in (("shared", insts), ("compacted", insts[:8]),
                          ("high_degree", [hub_instance()])):
        planted, xs = planted_like(source, np, 41)
        batch = pack_instances(planted, device="cuda")
        require(verify.use_verify_masks(batch), "verify_and_masks: the "
                f"planted {label} batch is not eligible")
        g = torch.Generator().manual_seed(43)
        V, F, B, E = (batch.num_vars, batch.num_clauses, batch.batch_size,
                      batch.num_edges)
        pred = torch.rand(V, generator=g)
        off = 0
        for b, x in enumerate(xs):
            if b % 2 == 0:
                pred[off:off + len(x)] = torch.from_numpy(x)
            off += len(x)
        p = pred.cuda()[:, None]
        problem = init_problem_state(batch)
        av = problem.active_vars * (torch.rand(V, generator=g) > 0.1
                                    ).float().cuda()
        ac = problem.active_clauses * (torch.rand(F, generator=g) > 0.1
                                       ).float().cuda()
        problem = problem.replace(active_vars=av, active_clauses=ac)
        act = batch.instance_mask.clone()
        act[::4] = 0.0

        def one():
            return verify.verify_and_masks(batch, problem, act, p)

        def plain():
            return verify.verify_and_masks_plain(batch, av, ac, act, p[:, 0])

        def split():
            solved, unsat = cnf_evaluate(batch, p)
            return (solved, unsat) + edge_masks_pair(
                batch, problem, act * (solved <= 0.5).float())

        got, ref, two = one(), plain(), split()
        torch.cuda.synchronize()
        for name, a, b, c in zip(("solved", "unsat", "em", "ae"), got, ref,
                                 two):
            require(torch.equal(a, b), f"verify_and_masks ({label}): {name} "
                    "differs from the plain version")
            require(torch.equal(a, c), f"verify_and_masks ({label}): {name} "
                    "differs from the split path")
        n_inst = len(source)
        solved = got[0][:n_inst].cpu()
        frozen = int(((act[:n_inst].cpu() > 0) & (solved > 0)).sum())
        require(int(solved.sum()) == (n_inst + 1) // 2 and (
            frozen > 0 or n_inst == 1), f"verify_and_masks ({label}): "
            f"{int(solved.sum())} solved, {frozen} frozen; the check needs "
            "both")
        e = batch.num_real_edges
        # ev, sign and edge_mask, the prediction and av, ac and cm, the
        # clause and instance offsets, the instance flags read once; em and
        # ae, solved and unsat written once; a few operations an edge
        nbytes = (3 * E + 2 * V + 3 * F + 1 + 2 * (B + 1) + 2 * E + 2 * B) * 4
        b_ms, b_by = bound_ms(nbytes, 8 * e)
        split_t = timed(split)
        cases[label] = dict(
            timed(one), cluster=verify._plan(batch).args.cluster,
            bound_ms=b_ms, bound_by=b_by, plain_ms=cuda_ms(plain, reps=10),
            split_path_ms=split_t["ms"], split_path_host_us=split_t["host_us"],
            split_path_device_us=split_t["device_us"],
            solved=int(solved.sum()), frozen_by_this_call=frozen,
            edges=E)
        r = cases[label]
        log(f"kernel verify_and_masks ({label}): exact against the plain "
            f"version and the split path ({r['solved']} of {n_inst} solved, "
            f"{frozen} frozen by this call), clusters of {r['cluster']}; "
            f"{timing_note(r)} (plain {r['plain_ms']:.4f} ms, split path "
            f"{timing_note(split_t)}; bound {b_ms:.5f} ms)")
    main = cases.pop("shared")
    row = {
        "name": "verify_and_masks", "route": "cuda",
        "source": "pdp_solver_tpu_torch/csrc/verify.cu",
        "replaces": "pdp_solver_tpu/ops/pallas_verify.py:170",
        "max_abs_err": 0.0, "library_ms": None,
        "library": "none exists; split_path_ms times the split path it "
                   "replaces (cnf_chain, the freeze, em_ae)"}
    row.update((k, main[k]) for k in (
        "ms", "host_us", "device_us", "cluster", "plain_ms", "bound_ms",
        "bound_by", "split_path_ms", "split_path_host_us",
        "split_path_device_us", "solved", "frozen_by_this_call"))
    row["cases"] = cases
    return {"verify_and_masks": row}


def reinforce_card_vs_cpu(insts, torch):
    """The REINFORCE forward from one injected state at full size, on the
    card and on the CPU, p = 1 (the coin always taken)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.modules.predict import survey_scorer_apply
    from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
    from pdp_solver_tpu_torch.utils.classical import REINFORCE
    solver = PDPSolver(SolverConfig(model_type="reinforce",
                                    pi=REINFORCE["pi"],
                                    decimation_probability=1.0))
    runs = {}
    for dev in ("cuda", "cpu"):
        batch = pack_instances(insts, device=dev)
        gen = torch.Generator().manual_seed(0)
        state = solver.get_init_state(gen, batch, randomized=True)
        _, s1, c1 = solver.forward({}, gen, batch, state, 1,
                                   check_termination=True, finalize=False)
        runs[dev] = (batch, s1, c1)
    bg, sg, cg = runs["cuda"]
    bc, sc, cc = runs["cpu"]
    score = survey_scorer_apply(solver.scorer_cfg, bc, sc.prop, cc[0])[0][:, 0]
    tie_v = (score.abs() < SCORE_TIE) & (bc.var_mask > 0)
    n_tie = int(tie_v.sum())
    real = bc.edge_mask > 0
    ok_e = real & ~tie_v[bc.edge_var]
    ok_v = (bc.var_mask > 0) & ~tie_v
    tie_b = torch.zeros(bc.batch_size, dtype=torch.bool)
    tie_b[bc.var_batch[tie_v]] = True
    force_g = sg.dec.fn[1].cpu()
    require(torch.equal(force_g[ok_e], sc.dec.fn[1][ok_e]),
            f"reinforce card vs cpu: {int((force_g != sc.dec.fn[1])[ok_e].sum())}"
            " forces differ after 1 iteration")
    require(torch.equal(cg[0].solution.cpu()[ok_v], cc[0].solution[ok_v]),
            "reinforce card vs cpu: predictions differ after 1 iteration")
    require(torch.equal(cg[1].cpu()[~tie_b], cc[1][~tie_b]),
            "reinforce card vs cpu: active flags differ after 1 iteration")
    msg_err = 0.0
    for a, b in zip(sg.prop.var + sg.prop.fn, sc.prop.var + sc.prop.fn):
        a = a.cpu()
        msg_err = max(msg_err, float((a[real] - b[real]).abs().max()))
        require(torch.allclose(a[real], b[real], **FLOAT_TOL),
                f"reinforce card vs cpu: SP messages differ by {msg_err}")
    # nine more iterations from there, each side on its own
    _, sg10, _ = solver.forward({}, torch.Generator().manual_seed(1), bg, sg,
                                9, check_termination=True, carry=cg,
                                finalize=False)
    _, sc10, _ = solver.forward({}, torch.Generator().manual_seed(1), bc, sc,
                                9, check_termination=True, carry=cc,
                                finalize=False)
    share = float((sg10.dec.fn[1].cpu() != sc10.dec.fn[1])[real]
                  .float().mean())
    require(share < MAX_FORCE_DIFF_SHARE,
            f"reinforce card vs cpu: {share:.4%} of the forces differ after "
            "10 iterations")
    return {"score_ties": n_tie, "message_max_abs_err": msg_err,
            "force_diff_share_10": share}


def replicated_forward(insts, torch):
    """p-d-p's forward(replication=2) on the shared set at the headline
    settings with REP_ITERATIONS iterations and REP_FLIPS WalkSAT flips,
    check_termination on: every instance's deduplicated solution verified
    with numpy against its CNF and against the solver's own verification
    (raises if they disagree)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.solvers.base import WALKSAT_K
    from pdp_solver_tpu_torch.train.loss import cnf_evaluate
    from pdp_solver_tpu_torch.utils.headline import (
        HEADLINE, headline_solver, verify_solution)
    solver = headline_solver(dict(HEADLINE, ls=REP_FLIPS))
    batch = pack_instances(insts, device="cuda")
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.time()
    state = solver.get_init_state(gen, batch, randomized=True,
                                  replication=2)
    (pred, _), _ = solver.forward({}, gen, batch, state, REP_ITERATIONS,
                                  check_termination=True, replication=2)
    torch.cuda.synchronize()
    wall = time.time() - t0
    require(pred.shape == (batch.num_vars, 1), "the replicated forward's "
            f"prediction has shape {tuple(pred.shape)}")
    sol = (pred[:, 0] > 0.5).float().cpu().numpy()
    ok, off = [], 0
    for inst in insts:
        ok.append(verify_solution(inst, sol[off:off + inst[0]]))
        off += inst[0]
    flags = cnf_evaluate(batch, pred)[0][:len(insts)].cpu().numpy() > 0
    if ok != flags.tolist():
        raise RuntimeError("a solution the solver reports disagrees with "
                           "numpy")
    return {"solved": sum(ok), "wall_s": wall,
            "blocks": REP_FLIPS // WALKSAT_K}


def _tensors(x):
    """The tensors of a state or carry (dataclasses, tuples), in order."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


class switches:
    """Environment switches set for a with block, as they were after."""

    def __init__(self, **kw):
        self.kw, self.old = kw, {}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kw}
        os.environ.update(self.kw)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_vs_cpu(insts, torch, replication=2):
    """Phase 13's forward(replication=2), or phase 34's folded forward
    (replication=1), from one injected state at full size, on the card and
    on the CPU, with the sweep folds on both sides (the card's default;
    PDP_FUSED_PASS=on on the CPU, whose default is the unfolded path, as
    the JAX package's is): after one iteration (the sequential
    decimator's first, which fixes nothing) every message and decimator
    column on every edge, padding included, to FLOAT_TOL, and the loop's
    carry (the problem's flags and solution, the active instances, the
    edge mask) exactly; then on to REP_CMP_ITERATIONS on each side from
    its own state, the decimator fixing variables, and the share of
    variables whose active flag or solution differs, which must stay
    under MAX_FORCE_DIFF_SHARE (a near tie of |score| that the order of a
    sum decides can send an instance another way)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances, replicate_batch
    from pdp_solver_tpu_torch.modules import propagate as PR
    from pdp_solver_tpu_torch.utils.headline import HEADLINE, headline_solver
    solver = headline_solver(dict(HEADLINE, ls=REP_FLIPS))
    R = replication
    what = "replicated card vs cpu" if R > 1 else "folded card vs cpu"
    on_cpu = switches(PDP_FUSED_PASS="on")
    runs = {}
    for dev in ("cuda", "cpu"):
        batch = pack_instances(insts, device=dev)
        gen = torch.Generator().manual_seed(0)
        state = solver.get_init_state(gen, batch, randomized=True,
                                      replication=R)
        with (on_cpu if dev == "cpu" else switches()):
            require(PR.sweep_folds(replicate_batch(batch, R) if R > 1
                                   else batch) == (True,) * 3,
                    f"{what}: the folds are off on the {dev}")
            _, s1, c1 = solver.forward({}, gen, batch, state, 1,
                                       check_termination=True,
                                       finalize=False, replication=R)
        runs[dev] = [replicate_batch(batch, R) if R > 1 else batch, s1, c1]
    (bg, sg, cg), (bc, sc, cc) = runs["cuda"], runs["cpu"]
    msg_err = 0.0
    for a, b in zip(_tensors(sg), _tensors(sc)):
        a = a.cpu()
        require(a.shape == b.shape, f"{what}: state shapes differ")
        if a.is_floating_point():
            msg_err = max(msg_err, float((a - b).abs().max()))
            require(torch.allclose(a, b, **FLOAT_TOL), f"{what}: states "
                    f"differ by {msg_err} after 1 iteration")
    carry_g, carry_c = _tensors(cg), _tensors(cc)
    for a, b in zip(carry_g, carry_c):
        require(torch.equal(a.cpu(), b), f"{what}: the problem, flags or "
                "edge mask differ after 1 iteration")
    for dev, run in runs.items():
        b, st, carry = run
        with (on_cpu if dev == "cpu" else switches()):
            _, run[1], run[2] = solver.forward(
                {}, torch.Generator().manual_seed(1), b, st,
                REP_CMP_ITERATIONS - 1,
                check_termination=True, carry=carry, finalize=False,
                replication=R)
    pg, pc = runs["cuda"][2][0], runs["cpu"][2][0]
    real = bc.var_mask > 0
    differ = ((pg.active_vars.cpu() != pc.active_vars)
              | (pg.solution.cpu() != pc.solution)) & real
    share = float(differ.sum()) / float(real.sum())
    fixed = int(((pc.active_vars == 0) & real).sum())
    flags = int((runs["cuda"][2][1].cpu() != runs["cpu"][2][1]).sum())
    require(share < MAX_FORCE_DIFF_SHARE, f"{what}: {share:.4%} of the "
            f"variables differ after {REP_CMP_ITERATIONS} iterations")
    return {"state_max_abs_err": msg_err, "var_diff_share": share,
            "inactive_vars": fixed, "flag_diffs": flags}


def neural_bf16_check(torch):
    """np-nd-np with the r3 weights on neural.BF16_CHECK's instances from
    one state drawn with numpy (neural.np_nd_np_state, the state the JAX
    package's figures were taken from), in f32 and bf16 on the card and
    in bf16 on the CPU, continued through neural.BF16_CHECK_HORIZONS (5
    and 10 iterations). At each: the card's and the CPU's active flags
    equal, and the card's f32-against-bf16 max |prediction difference|
    and its bf16 predictions' difference from the CPU's each at most
    neural.BF16_DRIFT_RATIO times JAX's own f32-against-bf16 difference
    there (neural.BF16_CHECK_JAX_DRIFT; two roundings of one function
    differ by no more than either differs from f32)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.utils import neural
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    insts = make_ksat_set(**neural.BF16_CHECK)
    runs = {}
    for dev, dtypes in (("cuda", ("float32", BF16)), ("cpu", (BF16,))):
        batch = pack_instances(insts, device=dev)
        state = neural.np_nd_np_state(batch.num_edges)
        params = neural.np_nd_np_params(dev)
        for dt in dtypes:
            runs[(dev, dt)] = neural.bf16_check_forward(params, batch, state,
                                                        dt)
    real = batch.var_mask > 0
    out = {}
    for i, h in enumerate(neural.BF16_CHECK_HORIZONS):
        (pf, _), (pb, ab), (pc, ac) = (
            runs[k][i] for k in (("cuda", "float32"), ("cuda", BF16),
                                 ("cpu", BF16)))
        jax_d = neural.BF16_CHECK_JAX_DRIFT[h]
        limit = neural.BF16_DRIFT_RATIO * jax_d
        drift = float((pf - pb)[real].abs().max())
        card_cpu = float((pb - pc)[real].abs().max())
        require(torch.equal(ab, ac), f"np-nd-np bf16 card vs cpu: active "
                f"flags differ after {h} iterations ({ab.tolist()} vs "
                f"{ac.tolist()})")
        require(drift <= limit, f"np-nd-np f32 against bf16 on the card: "
                f"max |prediction difference| {drift} > {limit} after {h} "
                f"iterations (JAX's own {jax_d})")
        require(card_cpu <= limit, f"np-nd-np bf16 card vs cpu: max "
                f"|prediction difference| {card_cpu} > {limit} after {h} "
                f"iterations")
        out[h] = dict(f32_bf16=drift, card_cpu=card_cpu, jax=jax_d,
                      limit=limit, solved=int((ab == 0).sum()))
    return out


def bf16_small_check(torch):
    """The JAX package's tests/test_bf16.py on the card: np-nd-np at
    BF16_SMALL's widths with fresh parameters (torch's default generator
    seeded with 0), three random 3-SAT instances of 10 variables and 25
    clauses, BF16_SMALL_ITERATIONS iterations with check_termination from
    one state in f32 and in bf16: the predictions finite and within
    MAX_BF16_PRED_DIFF of each other. Returns the max |difference|."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    batch = pack_instances(make_ksat_set(seed=2, count=3, n=10, alpha=2.5,
                                         k=3), device="cuda")
    solvers = [PDPSolver(SolverConfig(model_type="np-nd-np",
                                      compute_dtype=dt, **BF16_SMALL))
               for dt in ("float32", BF16)]
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(0)
        params = solvers[0].init_params("cuda")
    state = solvers[0].get_init_state(torch.Generator().manual_seed(1),
                                      batch, randomized=True)
    pred = [sv.forward(params, torch.Generator().manual_seed(2), batch,
                       state, BF16_SMALL_ITERATIONS,
                       check_termination=True)[0][0] for sv in solvers]
    diff = float((pred[0] - pred[1]).abs().max())
    require(pred[1].dtype == torch.float32
            and bool(torch.isfinite(pred[1]).all())
            and diff <= MAX_BF16_PRED_DIFF, f"tests/test_bf16.py's check on "
            f"the card: max |f32 - bf16 prediction| {diff} > "
            f"{MAX_BF16_PRED_DIFF} (or not finite)")
    return diff


class plain_route_guard:
    """While active, every plain version of a launching wrapper raises if
    it is handed a tensor or a batch on the card: the wrappers look them
    up by module name at each call, so the patch reaches every route."""

    NAMES = {"reduce2d": ("segment_sum_2d_plain", "gather_2d_plain"),
             "reduce": ("segment_sum_cols_plain", "segment_sum_plain",
                        "sorted_segment_sum_plain"),
             "fused": ("fused_edge_pass_plain", "chained_edge_pass_plain",
                       "segment_sum_cols_plain"),
             "walksat": ("walksat_walk_plain",),
             "sp_sweep": ("sp_full_sweep_plain",),
             "verify": ("verify_and_masks_plain",)}

    def __enter__(self):
        import importlib
        self.saved = []
        for mod, names in self.NAMES.items():
            m = importlib.import_module(f"pdp_solver_tpu_torch.ops.{mod}")
            for name in names:
                fn = getattr(m, name)
                self.saved.append((m, name, fn))
                setattr(m, name, self._guard(f"{mod}.{name}", fn))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)
        return False

    @staticmethod
    def _guard(label, fn):
        def on_card(x):
            dev = getattr(x, "device", None)
            if isinstance(x, (list, tuple)):
                return any(on_card(y) for y in x)
            return dev is not None and getattr(dev, "type", "") == "cuda"

        def guarded(*args, **kwargs):
            if any(on_card(a) for a in (*args, *kwargs.values())):
                raise SmokeFailure(f"the plain route {label} ran on the "
                                   "card")
            return fn(*args, **kwargs)
        return guarded


def bwd_counts():
    """The launches of kernels 6 and 7 since the last reset_counts: in
    all, and as the other's backward rule, by side."""
    from pdp_solver_tpu_torch.ops import reduce2d
    s, g = reduce2d.segment_sum_2d, reduce2d.gather_2d
    return {"segment_sum_2d": s.launches, "gather_2d": g.launches,
            "segment_sum_2d[bwd]": s.launches_bwd["var"],
            "segment_sum_2d[clause, bwd]": s.launches_bwd["clause"],
            "gather_2d[bwd]": g.launches_bwd["var"],
            "gather_2d[clause, bwd]": g.launches_bwd["clause"]}


def train_grad_check(torch, np):
    """Phase 19: the BPTT loss and every parameter's gradient on the card
    against the CPU (the plain versions), from the r3 weights and one
    numpy init state; the launches of kernels 6 and 7 during backward()
    alone."""
    from pdp_solver_tpu_torch import convert
    from pdp_solver_tpu_torch.train.trainer import SatTrainer
    from pdp_solver_tpu_torch.utils import neural, training
    cfg = dict(training.FLAGSHIP_RECIPE, dropout=0.0)
    tree = convert.load_jax_checkpoint(neural.CHECKPOINT)["params"]
    out = {}
    for dev in ("cuda", "cpu"):
        tr = SatTrainer(cfg, device=dev)
        convert.load_into(tr.params, tree)
        tr.params.train()
        batch = next(training.flagship_segments(3, TRAIN_GRAD_DIMS,
                                                device=dev))[0]
        state = training.numpy_init_state(batch, cfg["hidden_dim"], 11, dev)
        step = torch.tensor(TRAIN_EVAL_STEP, device=dev)
        t0 = time.time()
        if dev == "cuda":
            with plain_route_guard():
                loss = tr.loss(tr.params, batch, step, state)
                torch.cuda.synchronize()
                reset_counts()
                loss.backward()
                torch.cuda.synchronize()
            counts = bwd_counts()
        else:
            loss = tr.loss(tr.params, batch, step, state)
            loss.backward()
        out[dev] = dict(loss=float(loss.detach()), wall_s=time.time() - t0,
                        grads=convert.grads_to_jax(tr.params),
                        edges=batch.num_real_edges,
                        clause_width=batch.clause_width)
    card, cpu = out["cuda"], out["cpu"]
    require(card["clause_width"] == 0, "the segment has one clause width")
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    require(np.isfinite(card["loss"]) and loss_rel <= TRAIN_LOSS_RTOL,
            f"loss card {card['loss']} cpu {cpu['loss']}: rel {loss_rel}")
    rels, cpu_grads = {}, dict(convert._flatten(cpu["grads"]))
    for key, g_card in convert._flatten(card["grads"]):
        g_cpu = cpu_grads[key]
        rel = float(np.linalg.norm(g_card - g_cpu)
                    / max(np.linalg.norm(g_cpu), 1e-30))
        require(np.isfinite(g_card).all() and rel <= TRAIN_GRAD_REL,
                f"gradient {key}: card against cpu rel {rel}")
        rels[key] = rel
    for k in ("segment_sum_2d[bwd]", "gather_2d[bwd]",
              "segment_sum_2d[clause, bwd]", "gather_2d[clause, bwd]"):
        require(counts[k] > 0, f"{k} never launched during backward()")
    return dict(loss_card=card["loss"], loss_cpu=cpu["loss"],
                loss_rel=loss_rel, grad_rel_max=max(rels.values()),
                grad_rel_worst=max(rels, key=rels.get), n_grads=len(rels),
                edges=card["edges"], card_s=card["wall_s"],
                cpu_s=cpu["wall_s"], backward_counts=counts)


def heldout_energy(tr, params, batch, state, torch):
    """The BPTT energy of a held-out segment at TRAIN_EVAL_STEP, dropout
    off, no gradient."""
    params.eval()
    with torch.no_grad():
        e = float(tr.loss(params, batch, torch.tensor(
            TRAIN_EVAL_STEP, device=batch.device), state))
    params.train()
    return e


def train_flagship(torch, np):
    """Phase 20: TRAIN_STEPS steps at the flagship recipe from a fresh
    init."""
    import itertools
    from pdp_solver_tpu_torch.train.trainer import SatTrainer
    from pdp_solver_tpu_torch.utils import training
    cfg = training.FLAGSHIP_RECIPE
    t0 = time.time()
    segs = list(itertools.islice(training.flagship_segments(0), TRAIN_STEPS))
    gen_s = time.time() - t0
    held = next(training.flagship_segments(12345))[0]
    held_state = training.numpy_init_state(held, cfg["hidden_dim"], 7,
                                           "cuda")
    tr = SatTrainer(cfg, seed=0, device="cuda")
    ts = tr.init_train_state()
    e0 = heldout_energy(tr, ts.params, held, held_state, torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with plain_route_guard():
        t1 = time.time()
        ts, losses, n0 = tr.train_segments(ts, iter(segs[:1]))
        torch.cuda.synchronize()
        first_s = time.time() - t1
        t2 = time.time()
        ts, more, n1 = tr.train_segments(ts, iter(segs[1:-1]))
        torch.cuda.synchronize()
        steady_s = time.time() - t2
        reset_counts()
        ts, last, n2 = tr.train_segments(ts, iter(segs[-1:]))
        torch.cuda.synchronize()
        step_counts = bwd_counts()
        step_counts["segment_sum_cols"] = read_counts()["segment_sum_cols"]
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses + more + last).cpu().numpy()
    require(np.isfinite(losses).all(), "a training loss is not finite")
    e1 = heldout_energy(tr, ts.params, held, held_state, torch)
    require(e1 < e0, f"held-out energy {e1} after {TRAIN_STEPS} steps not "
            f"below {e0} before")
    n_steady = len(segs) - 2
    return dict(segments=segs, steps=len(losses), gen_s=gen_s,
                gen_ms_per_segment=gen_s / len(segs) * 1e3,
                first_step_s=first_s,
                ms_per_step=steady_s / n_steady * 1e3,
                instances_per_s=n1 / steady_s,
                instances_per_step=(n0 + n1 + n2) / len(losses),
                peak_bytes=peak, energy_before=e0, energy_after=e1,
                loss_first10=float(losses[:10].mean()),
                loss_last10=float(losses[-10:].mean()),
                global_step=float(ts.global_step), step_counts=step_counts)


def finetune_and_serve(segs, insts, torch, np):
    """Phase 21: 50 steps from the r3 weights, saved and read back bit for
    bit, then served on the shared set."""
    from pdp_solver_tpu_torch import convert
    from pdp_solver_tpu_torch.train.trainer import SatTrainer
    from pdp_solver_tpu_torch.utils import neural, training
    from pdp_solver_tpu_torch.utils.neural import solve_np_nd_np
    cfg = training.FLAGSHIP_RECIPE
    tr = SatTrainer(cfg, seed=1, device="cuda")
    r3 = os.path.dirname(neural.CHECKPOINT)
    ts = tr._load_train_state(tr.init_train_state(), r3)
    require(not ts.opt.state, "Adam is not fresh after the params-only r3")
    with plain_route_guard():
        ts, losses, _ = tr.train_segments(ts, iter(segs[:FINETUNE_STEPS]))
        losses = torch.stack(losses).cpu().numpy()
    require(bool(np.isfinite(losses).all()), "a fine-tune loss is not "
            "finite")
    out = os.path.join(ROOT, "pdp_solver_tpu_torch", "_build", "finetune")
    trained = {k: v.detach().clone()
               for k, v in ts.params.named_parameters()}
    for d in ("last", "best"):
        tr._save_train_state(ts, os.path.join(out, d))
        tree = convert.load_jax_checkpoint(
            os.path.join(out, d, cfg["model_name"] + ".npz"))
        require(int(tree["opt"][2]["count"]) == FINETUNE_STEPS,
                f"{d}: Adam count {tree['opt'][2]['count']}")
        params = convert.params_from_jax(tree["params"], "cuda")
        for k, v in params.named_parameters():
            require(torch.equal(v, trained[k]), f"{d}: {k} not bit-exact")
    with plain_route_guard():
        res = solve_np_nd_np(insts, seed=0, params=params)
    return dict(res, loss_first10=float(losses[:10].mean()),
                loss_last10=float(losses[-10:].mean()))


def step_counts():
    """Every launch count since the last reset_counts, kernels 6 and 7 by
    side as each other's backward, and the calls of kernel 4's rule."""
    from pdp_solver_tpu_torch.ops import reduce
    counts = read_counts()
    counts.update(bwd_counts())
    counts["segment_sum_cols[rule]"] = reduce.segment_sum_cols.backward_calls
    return counts


def r4_params(model):
    from pdp_solver_tpu_torch import convert
    d = os.path.join(ROOT, R4_STATE[model])
    return convert.load_jax_checkpoint(
        os.path.join(d, f"{model}-r4.npz"))["params"]


def np_d_np_problems(tr, batch, state, steps, torch):
    """np-d-np's training forward outer step by outer step under no_grad:
    the problem each step leaves and the state entering each step."""
    problems, states = [], [state]
    t_inner = int(tr._config.get("train_inner_recurrence_num", 1))
    with torch.no_grad():
        for _ in range(steps):
            problem, state, _ = tr.solver._train_core(
                tr.params, None, batch, state, t_inner)
            problems.append(problem)
            states.append(state)
    return problems, states


def pick_gap(tr, batch, state, inst, torch):
    """The CPU's gap between the two largest |score| of instance `inst`'s
    variables, from the state entering the step (a fresh problem)."""
    from pdp_solver_tpu_torch.problem.state import (
        edge_active_instance_mask, init_problem_state)
    s = tr.solver
    with torch.no_grad():
        ae = edge_active_instance_mask(batch, batch.instance_mask)
        prop = s._propagate(tr.params, batch, state.prop, state.dec,
                            batch.edge_mask, ae)
        score = s._scorer_fn(tr.params, batch)(prop,
                                               init_problem_state(batch))
    mine = torch.abs(score[:, 0])[(batch.var_batch == inst)
                                  & (batch.var_mask > 0)]
    top = torch.topk(mine, 2).values
    return float(top[0] - top[1])


def compare_problems(sides, steps, torch, np):
    """Phase 23's gate: the card's and the CPU's decimated problems after
    each outer step. Returns (the steps that agree, the first differing
    pick or None); fails where a pick differs by more than a tie."""
    runs = {dev: np_d_np_problems(tr, batch, state, steps, torch)
            for dev, (tr, batch, state) in sides.items()}
    for t in range(steps):
        card = runs["cuda"][0][t]
        cpu = runs["cpu"][0][t]
        diff = [f for f in ("active_vars", "active_clauses", "solution",
                            "is_sat")
                if not torch.equal(getattr(card, f).cpu(), getattr(cpu, f))]
        if not diff:
            continue
        tr, batch, _ = sides["cpu"]
        av = (card.active_vars.cpu() != cpu.active_vars).nonzero()
        v = int(av[0]) if len(av) else 0
        inst = int(batch.var_batch[v])
        gap = pick_gap(tr, batch, runs["cpu"][1][t], inst, torch)
        log(f"phase 23 np-d-np: the problems differ after outer step "
            f"{t + 1} ({diff}; variable {v}, instance {inst}): the CPU's "
            f"|score| gap there {gap:.3g}")
        require(gap < PICK_TIE_GAP and t >= 1,
                f"np-d-np's decimation differs card against cpu at step "
                f"{t + 1} with a |score| gap {gap} >= {PICK_TIE_GAP}")
        return t, dict(step=t + 1, variable=v, instance=inst, gap=gap)
    return steps, None


def family_grad_check(model, torch, np):
    """Phases 22-23: the BPTT loss and every parameter's gradient on the
    card against the CPU, from the r4 weights and one numpy init state;
    the launches in the forward (with remat's recompute) and during
    backward() alone."""
    from pdp_solver_tpu_torch import convert
    from pdp_solver_tpu_torch.train.trainer import SatTrainer
    from pdp_solver_tpu_torch.utils import training
    cfg = dict(training.FAMILY_RECIPES[model], dropout=0.0)
    tree = r4_params(model)
    sides = {}
    for dev in ("cuda", "cpu"):
        tr = SatTrainer(cfg, device=dev)
        convert.load_into(tr.params, tree)
        tr.params.train()
        batch = next(training.family_segments(3, model, TRAIN_GRAD_DIMS,
                                              device=dev))[0]
        state = training.numpy_init_state(batch, cfg["hidden_dim"], 11, dev,
                                          model)
        sides[dev] = (tr, batch, state)
    steps, tie = cfg["train_outer_recurrence_num"], None
    if model == "np-d-np":
        with plain_route_guard():
            steps, tie = compare_problems(sides, steps, torch, np)
    out = {}
    for dev, (tr, batch, state) in sides.items():
        tr._config["train_outer_recurrence_num"] = steps
        step = torch.tensor(TRAIN_EVAL_STEP, device=dev)
        t0 = time.time()
        if dev == "cuda":
            with plain_route_guard():
                reset_counts()
                loss = tr.loss(tr.params, batch, step, state)
                torch.cuda.synchronize()
                fwd = step_counts()
                reset_counts()
                loss.backward()
                torch.cuda.synchronize()
                bwd = step_counts()
        else:
            loss = tr.loss(tr.params, batch, step, state)
            loss.backward()
        out[dev] = dict(loss=float(loss.detach()), wall_s=time.time() - t0,
                        grads=convert.grads_to_jax(tr.params),
                        edges=batch.num_real_edges,
                        clause_width=batch.clause_width)
    card, cpu = out["cuda"], out["cpu"]
    require(card["clause_width"] == 0, "the segment has one clause width")
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    require(np.isfinite(card["loss"]) and loss_rel <= FAMILY_LOSS_RTOL,
            f"{model} loss card {card['loss']} cpu {cpu['loss']}: rel "
            f"{loss_rel}")
    rels, cpu_grads = {}, dict(convert._flatten(cpu["grads"]))
    for key, g_card in convert._flatten(card["grads"]):
        g_cpu = cpu_grads[key]
        rel = float(np.linalg.norm(g_card - g_cpu)
                    / max(np.linalg.norm(g_cpu), 1e-30))
        require(np.isfinite(g_card).all() and rel <= TRAIN_GRAD_REL,
                f"{model} gradient {key}: card against cpu rel {rel}")
        rels[key] = rel
    require(fwd["segment_sum_cols"] > 0 and bwd["segment_sum_cols[rule]"] > 0,
            f"{model}: kernel 4 forward {fwd['segment_sum_cols']}, its rule "
            f"{bwd['segment_sum_cols[rule]']} during backward()")
    require(bwd["gather_2d[bwd]"] > 0, f"{model}: kernel 7 never launched "
            "as SegmentSum2d's backward")
    if model == "p-nd-np":
        for k in SERVING_SWEEP:
            require(fwd.get(k, 0) == 0 and bwd.get(k, 0) == 0,
                    f"p-nd-np's training step launched {k}")
    else:
        for k in ("smax", "sround"):
            require(fwd.get(k, 0) > 0, f"np-d-np's training step never "
                    f"launched {k}")
        for k in ("segment_sum_2d[bwd]", "segment_sum_2d[clause, bwd]",
                  "gather_2d[clause, bwd]"):
            require(bwd[k] > 0, f"np-d-np: {k} never launched during "
                    "backward()")
    keep = ("segment_sum_cols", "segment_sum_cols[rule]", "segment_sum_2d",
            "gather_2d", "segment_sum_2d[bwd]", "segment_sum_2d[clause, bwd]",
            "gather_2d[bwd]", "gather_2d[clause, bwd]", "smax", "sround",
            "em_ae", "em", "ae", "cnf_chain") + SERVING_SWEEP
    return dict(loss_card=card["loss"], loss_cpu=cpu["loss"],
                loss_rel=loss_rel, grad_rel_max=max(rels.values()),
                grad_rel_worst=max(rels, key=rels.get), n_grads=len(rels),
                edges=card["edges"], steps=steps, tie=tie,
                card_s=card["wall_s"], cpu_s=cpu["wall_s"],
                forward_counts={k: fwd.get(k, 0) for k in keep},
                backward_counts={k: bwd.get(k, 0) for k in keep})


def train_family(model, segs, torch, np):
    """Phase 24: FAMILY_STEPS steps at an r4 recipe from a fresh init."""
    from pdp_solver_tpu_torch.train.trainer import SatTrainer
    from pdp_solver_tpu_torch.utils import training
    cfg = training.FAMILY_RECIPES[model]
    held = next(training.family_segments(12345, model))[0]
    held_state = training.numpy_init_state(held, cfg["hidden_dim"], 7,
                                           "cuda", model)
    tr = SatTrainer(cfg, seed=0, device="cuda")
    ts = tr.init_train_state()
    e0 = heldout_energy(tr, ts.params, held, held_state, torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with plain_route_guard():
        t1 = time.time()
        ts, losses, n0 = tr.train_segments(ts, iter(segs[:1]))
        torch.cuda.synchronize()
        first_s = time.time() - t1
        t2 = time.time()
        ts, more, n1 = tr.train_segments(ts, iter(segs[1:-1]))
        torch.cuda.synchronize()
        steady_s = time.time() - t2
        reset_counts()
        ts, last, n2 = tr.train_segments(ts, iter(segs[-1:]))
        torch.cuda.synchronize()
        counts = step_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses + more + last).cpu().numpy()
    require(np.isfinite(losses).all(), f"a {model} training loss is not "
            "finite")
    e1 = heldout_energy(tr, ts.params, held, held_state, torch)
    require(e1 < e0, f"{model}: held-out energy {e1} after {len(losses)} "
            f"steps not below {e0} before")
    for k in SERVING_SWEEP if model == "p-nd-np" else ():
        require(counts.get(k, 0) == 0, f"p-nd-np's training step launched "
                f"{k}")
    n_steady = len(segs) - 2
    return dict(steps=len(losses), first_step_s=first_s,
                ms_per_step=steady_s / n_steady * 1e3,
                instances_per_s=n1 / steady_s,
                instances_per_step=(n0 + n1 + n2) / len(losses),
                peak_bytes=peak, energy_before=e0, energy_after=e1,
                loss_first10=float(losses[:10].mean()),
                loss_last10=float(losses[-10:].mean()),
                step_counts={k: v for k, v in counts.items()
                             if isinstance(v, int) and v})


def train_meta_config(segs, torch, np):
    """Phase 24: 10 steps of config/Train/p-nd-np-cnf-3-10.yaml (meta
    width 1) on segments without meta features: zeros injected."""
    from pdp_solver_tpu_torch.train.trainer import SatTrainer
    from pdp_solver_tpu_torch.utils import config, training
    try:
        cfg = config.load_yaml_config(training.P_ND_NP_CNF_3_10_YAML)
        source = "the YAML"
    except ImportError:
        cfg = training.P_ND_NP_CNF_3_10
        source = ("utils/training.py P_ND_NP_CNF_3_10 (no PyYAML here; "
                  "tests/test_torch_meta.py holds it equal to the YAML)")
    cfg = config.validate(config.merge_config(cfg, {}))
    tr = SatTrainer(cfg, seed=0, device="cuda")
    require(tr.solver.cfg.meta_dim == 1, "the config's meta width is not 1")
    require(all(b.graph_feat.shape[1] == 0 for b, _, _ in segs[:META_STEPS]),
            "the segments carry meta features")
    ts = tr.init_train_state()
    with plain_route_guard():
        ts, losses, _ = tr.train_segments(ts, iter(segs[:META_STEPS]))
    losses = torch.stack(losses).cpu().numpy()
    require(np.isfinite(losses).all(), "a p-nd-np-cnf-3-10 loss is not "
            "finite")
    return dict(source=source, steps=len(losses),
                loss_first=float(losses[0]), loss_last=float(losses[-1]))


def resume_and_serve(model, segs, insts, torch, np):
    """Phase 25: an r4 train state (params and Adam) resumed for 20
    steps, saved and read back bit for bit, then served."""
    from pdp_solver_tpu_torch import convert
    from pdp_solver_tpu_torch.train.trainer import SatTrainer
    from pdp_solver_tpu_torch.utils import training
    from pdp_solver_tpu_torch.utils.neural import (
        np_d_np_3sat_band, solve_p_nd_np)
    cfg = training.FAMILY_RECIPES[model]
    tr = SatTrainer(cfg, seed=1, device="cuda")
    ts = tr._load_train_state(tr.init_train_state(),
                              os.path.join(ROOT, R4_STATE[model]))
    count0 = int(convert.adam_to_jax(ts.opt, ts.params)["count"])
    require(count0 > 0, f"{model}-r4: Adam's state did not load")
    with plain_route_guard():
        ts, losses, _ = tr.train_segments(ts, iter(segs[:RESUME_STEPS]))
    losses = torch.stack(losses).cpu().numpy()
    require(bool(np.isfinite(losses).all()), f"a resumed {model} loss is "
            "not finite")
    out = os.path.join(ROOT, "pdp_solver_tpu_torch", "_build", "resume",
                       model)
    trained = {k: v.detach().clone()
               for k, v in ts.params.named_parameters()}
    for d in ("last", "best"):
        tr._save_train_state(ts, os.path.join(out, d))
        tree = convert.load_jax_checkpoint(
            os.path.join(out, d, cfg["model_name"] + ".npz"))
        require(int(tree["opt"][2]["count"]) == count0 + RESUME_STEPS,
                f"{model} {d}: Adam count {tree['opt'][2]['count']}")
        params = convert.params_from_jax(tree["params"], "cuda")
        for k, v in params.named_parameters():
            require(torch.equal(v, trained[k]),
                    f"{model} {d}: {k} not bit-exact")
    with plain_route_guard():
        res = (solve_p_nd_np(insts, seed=0, params=params)
               if model == "p-nd-np" else np_d_np_3sat_band(params))
    return dict(res, adam_count=count0, loss_first=float(losses[0]),
                loss_last=float(losses[-1]))


def check_backward_kernels(batch, torch):
    """The backward forms of kernels 6 and 7 at a training segment's
    shape (d = 50, the aggregators' width): kernel 6 over the var and the
    clause CSR as Gather2d's backward, kernel 7 with i64 ids as
    SegmentSum2d's (the padding rows then zeroed), against their plain
    versions, timed beside index_add_ / index_select and the bound; and
    kernel 4's rule, a PyTorch index, timed."""
    from pdp_solver_tpu_torch.ops import reduce, reduce2d
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    E, d, e = batch.num_edges, HIDDEN_AGG, batch.num_real_edges
    gen = torch.Generator().manual_seed(23)
    cot = torch.randn(E, d, generator=gen).cuda()
    cot[e:] = 0.0
    rows = {}
    sides = {"": (batch.edge_var32, batch.edge_var, batch.num_vars,
                  batch.var_ptr, batch.var_perm, batch.var_max_degree),
             "clause, ": (batch.edge_clause32, batch.edge_clause,
                          batch.num_clauses, batch.clause_ptr, None,
                          batch.clause_max_degree)}
    for side, (ids32, ids64, n, ptr, perm, md) in sides.items():
        # Gather2d's backward: the largest degree from the batch's Csr
        def seg():
            return reduce2d._segment_sum_2d(cot, ids32, n, e, ptr, perm, md)

        def seg_plain():
            return reduce2d.segment_sum_2d_plain(cot, ids64, n, e)
        got, ref = seg(), seg_plain()
        again = seg()
        emu = reduce2d.walk_order_sum_2d(cot, ptr, perm)
        ref64 = torch.zeros(n, d, dtype=torch.float64,
                            device="cuda").index_add_(0, ids64[:e],
                                                      cot[:e].double())
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        require(torch.allclose(got, ref, **REDUCE2D_TOL),
                f"segment_sum_2d[{side}bwd]: max abs err {err}")
        require(torch.equal(got, again) and torch.equal(got, emu),
                f"segment_sum_2d[{side}bwd]: not the bits of "
                "walk_order_sum_2d, or two calls differ")
        require(torch.allclose(got.double(), ref64, **REDUCE2D_TOL),
                f"segment_sum_2d[{side}bwd]: beyond REDUCE2D_TOL of "
                "float64")
        out = torch.zeros(n, d, device="cuda")
        lib = timed(lambda: out.index_add_(0, ids64[:e], cot[:e]))
        perm_n = 0 if perm is None else e
        b_ms, b_by = bound_ms((e * d + perm_n + n + 1 + n * d) * 4, e * d)
        rows[f"segment_sum_2d[{side}bwd]"] = dict(
            timed(seg), name=f"segment_sum_2d[{side}bwd]", route="cuda",
            source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
            replaces=f"{PALLAS_2D}:152", max_abs_err=err,
            plain_ms=cuda_ms(seg_plain, reps=20), bound_ms=b_ms,
            bound_by=b_by, library_ms=lib["ms"],
            library_device_us=lib["device_us"],
            library="index_add_ over the real edges",
            shape=dict(E=E, real=e, nodes=n, d=d))

        nodes = torch.randn(n, d, generator=gen).cuda()

        def gat():
            gx = reduce2d._gather_2d(nodes, ids64)
            gx[e:] = 0.0
            return gx

        def gat_plain():
            gx = reduce2d.gather_2d_plain(nodes, ids64)
            gx[e:] = 0.0
            return gx
        got, ref = gat(), gat_plain()
        torch.cuda.synchronize()
        require(torch.equal(got, ref), f"gather_2d[{side}bwd]: not exact")
        lib = timed(lambda: nodes.index_select(0, ids64))
        b_ms, b_by = bound_ms(E * 8 + (n * d + E * d) * 4, 0)
        rows[f"gather_2d[{side}bwd]"] = dict(
            timed(gat), name=f"gather_2d[{side}bwd]", route="cuda",
            source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
            replaces=f"{PALLAS_2D}:142", max_abs_err=0.0,
            plain_ms=cuda_ms(gat_plain, reps=20), bound_ms=b_ms,
            bound_by=b_by, library_ms=lib["ms"],
            library_device_us=lib["device_us"],
            library="index_select (i64 ids)",
            shape=dict(E=E, real=e, nodes=n, d=d))
    for r in rows.values():
        log(f"kernel {r['name']}: ok, max abs err {r['max_abs_err']:.3g}, "
            f"{timing_note(r)} (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, device "
            f"{r['library_device_us']:.2f} us; bound {r['bound_ms']:.5f} "
            f"ms, {r['bound_by']})")
    # the forward forms at this shape: f32 and bf16 rows, both CSRs
    walk = check_sum2d_walk({"training": batch}, torch)
    rows["segment_sum_2d[bwd]"]["walk_cases"] = walk
    # kernel 4's rule is no kernel: a PyTorch index of the loss's two
    # clause columns' cotangent (JAX's is an XLA gather), timed for the
    # table
    g2 = torch.randn(2, batch.num_clauses, generator=gen).cuda()
    idx = timed(lambda: [reduce._gather_real(c, batch.edge_clause, e)
                         for c in g2])
    b_ms, _ = bound_ms(2 * (E * 8 + batch.num_clauses * 4 + E * 4), 0)
    log(f"kernel 4's backward (2 clause columns, a PyTorch index each): "
        f"{timing_note(idx)}, bound {b_ms:.5f} ms (bytes)")
    return rows


# ---------------------------------------------------------------- the CLIs

def instance_clauses(inst):
    """The signed 1-based clauses of an instance tuple, in edge order."""
    n, m, gmap, signs = inst[:4]
    out = [[] for _ in range(m)]
    for v, c, s in zip(gmap[0].tolist(), gmap[1].tolist(), signs.tolist()):
        out[c].append((v + 1) * (1 if s > 0 else -1))
    return out


def unsat_count(inst, sol, np):
    """numpy's count of the instance's clauses the 0/1 assignment leaves
    unsatisfied."""
    n, m, gmap, signs = inst[:4]
    x = np.asarray(sol, np.float64)
    lit = np.where(signs > 0, x[gmap[0]], 1.0 - x[gmap[0]])
    sat = np.zeros(m)
    np.add.at(sat, gmap[1], lit > 0.5)
    return int((sat == 0).sum())


def read_rows(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def check_rows(rows, insts, np, what):
    """Each row's unsat_clauses against numpy's count for its instance,
    and solved against (count == 0)."""
    for i, (row, inst) in enumerate(zip(rows, insts)):
        require(len(row["solution"]) == inst[0], f"{what}: row {i} has "
                f"{len(row['solution'])} variables, its instance {inst[0]}")
        u = unsat_count(inst, row["solution"], np)
        require(row["unsat_clauses"] == u and row["solved"] == int(u == 0),
                f"{what}: row {i} says unsat {row['unsat_clauses']} solved "
                f"{row['solved']}, numpy counts {u}")


def cli_dimacs_serve(insts, np, device="cuda"):
    """Phase 26: the shared set written as 128 DIMACS files, served by
    satyr -d with the r3 config, in this process (launch counts reset
    before, read after)."""
    import tempfile
    from pdp_solver_tpu_torch.cli import dimacs2json, satyr
    from pdp_solver_tpu_torch.fg import native
    from pdp_solver_tpu_torch.fg.dimacs import write_dimacs
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "cnf")
        os.makedirs(d)
        names = [f"inst{i:03d}.cnf" for i in range(len(insts))]
        t0 = time.time()
        for name, inst in zip(names, insts):
            write_dimacs(os.path.join(d, name), inst[0],
                         instance_clauses(inst))
        write_s = time.time() - t0
        # the converter alone, timed once (satyr -d runs it again)
        t0 = time.time()
        dimacs2json.convert_directory(d, os.path.join(tmp, "once.json"),
                                      False)
        convert_s = time.time() - t0
        out = os.path.join(tmp, "out.json")
        argv = [CLI_R3_YAML, d, str(CLI_ITERATIONS), "-d", "-w",
                str(CLI_ITERATIONS), "-s", "0",
                "-o", out] + (["-c"] if device == "cpu" else [])
        t0 = time.time()
        _, launches = run_path(lambda: satyr.main(argv))
        wall = time.time() - t0
        rows = read_rows(out)
        temp_gone = not os.path.exists(os.path.join(
            d, "temp_problem_file.json"))
    require(len(rows) == len(insts), f"phase 26: {len(rows)} rows")
    require([r["ID"] for r in rows] == names,
            "phase 26: the rows' IDs are not the file names in file order")
    check_rows(rows, insts, np, "phase 26")
    require(temp_gone, "phase 26: temp_problem_file.json was left behind")
    return {"rows": rows, "solved": sum(r["solved"] for r in rows),
            "launches": launches, "wall_s": wall,
            "write_ms_per_file": 1e3 * write_s / len(insts),
            "convert_ms_per_file": 1e3 * convert_s / len(insts),
            "native": native.available()}


def profile_lines(text):
    return [json.loads(l[len("PDP_PROFILE "):]) for l in text.splitlines()
            if l.startswith("PDP_PROFILE ")]


def cli_process_pdp(np, device="cuda"):
    """Phase 27: satyr as a process on the committed sample with
    PDP_PROFILE=1, then SatTrainer(config).predict on the same file with
    the same seed in this process."""
    import tempfile
    from pdp_solver_tpu_torch.cli import satyr
    from pdp_solver_tpu_torch.fg.jsonfmt import read_json_dataset
    from pdp_solver_tpu_torch.utils.config import (
        apply_classical_overrides, load_yaml_config, make_logger,
        merge_config, validate)
    insts = read_json_dataset(CLI_SAMPLE)
    argv = [CLI_PDP_YAML, CLI_SAMPLE, "80", "-w", "100", "-s", "0"] + (
        ["-c"] if device == "cpu" else [])
    with tempfile.TemporaryDirectory() as tmp:
        out, again = os.path.join(tmp, "out.json"), os.path.join(
            tmp, "again.json")
        env = dict(os.environ, PDP_PROFILE="1", PYTHONPATH=ROOT)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "pdp_solver_tpu_torch.cli.satyr"] + argv
            + ["-o", out], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.time() - t0
        require(proc.returncode == 0, f"phase 27: satyr exited "
                f"{proc.returncode}: {proc.stderr[-2000:]}")
        rows = read_rows(out)
        args = satyr.parse_args(argv + ["-o", again])
        config = validate(apply_classical_overrides(merge_config(
            load_yaml_config(args["model_config"]), args)))
        satyr.run(config, make_logger(config["model_name"]), again, device)
        with open(out) as f, open(again) as g:
            lines, lines2 = f.read().splitlines(), g.read().splitlines()
    require(len(rows) == len(insts), f"phase 27: {len(rows)} rows")
    check_rows(rows, insts, np, "phase 27")
    solved = sum(r["solved"] for r in rows)
    require(solved >= MIN_SOLVED_SAMPLE, f"phase 27: solved {solved} < "
            f"{MIN_SOLVED_SAMPLE}")
    recs = profile_lines(proc.stderr)
    require(len(recs) == 1, f"phase 27: {len(recs)} PDP_PROFILE lines")
    rec = recs[0]
    require("solve_ms" in rec and "output_ms" in rec,
            f"phase 27: the profile lacks solve/output: {rec}")
    require(all(rec.get(k, 0) > 0 for k in SLOPE_KEYS),
            f"phase 27: a phase slope is not > 0: {rec}")
    for i, (a, b) in enumerate(zip(lines, lines2)):
        require(a == b, f"phase 27: row {i} differs between the process "
                f"and SatTrainer.predict:\n  {a}\n  {b}")
    require(len(lines) == len(lines2), "phase 27: the two runs wrote "
            f"{len(lines)} and {len(lines2)} lines")
    return {"solved": solved, "profile": rec, "wall_s": wall, "lines": lines}


def cli_generate(tmp, np, device="cuda"):
    """Phase 28, first part: generate's two labelled bands, and each
    band's DIMACS directory converted back."""
    from pdp_solver_tpu_torch.cli import dimacs2json, generate
    from pdp_solver_tpu_torch.fg.dimacs import compact
    from pdp_solver_tpu_torch.fg.jsonfmt import read_json_dataset
    from pdp_solver_tpu_torch.ops import fused, walksat
    dd, jd = os.path.join(tmp, "dimacs"), os.path.join(tmp, "json")
    argv = [dd, jd] + GENERATE_ARGS + (["-c"] if device == "cpu" else [])
    t0 = time.time()
    _, launches = run_path(lambda: generate.main(argv))
    totals = {"kernel 1": fused.fused_edge_pass.launches,
              "kernel 2": fused.chained_edge_pass.launches,
              "kernel 3": walksat.walksat_walk.launches}
    wall = time.time() - t0
    bands = sorted(os.listdir(jd))
    require(len(bands) == 2, f"phase 28: bands {bands}")
    labelled, renumbered = [], 0
    for band in bands:
        rows = read_json_dataset(os.path.join(jd, band))
        require(len(rows) == 32, f"phase 28: {band} has {len(rows)} rows")
        conv = os.path.join(tmp, "conv_" + band)
        dimacs2json.convert_directory(
            os.path.join(dd, band[:-len(".json")]), conv, False)
        back = read_json_dataset(conv)
        require(len(back) == 32, f"phase 28: {band}'s DIMACS gave "
                f"{len(back)} rows")
        for b in back:
            i = int(b[5][0].split("_")[1])
            want_n, want = compact(rows[i][0], instance_clauses(rows[i]))
            renumbered += want_n != rows[i][0]
            require((b[0], instance_clauses(b), b[4]) ==
                    (want_n, want, rows[i][4]), f"phase 28: {b[5][0]} "
                    f"differs from row {i} of {band}")
        labelled.append(sum(r[4] == 1.0 for r in rows))
    return {"labelled": labelled, "bands": bands, "json_dir": jd,
            "renumbered": renumbered, "launches": launches,
            "totals": totals, "wall_s": wall}


def reorder_path(np, device="cuda"):
    """Phase 28, second part: modular instances reordered, solved by p-d-p
    at the headline settings, mapped back and verified against their
    original clauses."""
    import torch
    from pdp_solver_tpu_torch.fg.generators import ModularCNFGenerator
    from pdp_solver_tpu_torch.fg.reorder import (
        reorder_instances, restore_solution)
    from pdp_solver_tpu_torch.solvers.compact import compacting_solve
    from pdp_solver_tpu_torch.utils.headline import (
        HEADLINE, headline_solver, verify_solution)
    m = MODULAR_N1000
    g = ModularCNFGenerator(m["k"], m["min_n"], m["max_n"], m["min_q"],
                            m["max_q"], m["min_c"], m["max_c"], m["min_a"],
                            m["max_a"], seed=m["seed"])
    insts = [g.generate() for _ in range(MODULAR_COUNT)]
    t0 = time.time()
    reordered, orders = reorder_instances(insts)
    reorder_s = time.time() - t0
    h = dict(HEADLINE, ls=MODULAR_FLIPS_PER_VAR * m["max_n"])
    t0 = time.time()
    sols, solved, _ = compacting_solve(
        headline_solver(h), {}, torch.Generator().manual_seed(0), reordered,
        h["iterations"], ls_iterations=h["ls"], chunk=h["chunk"],
        min_edges=h["min_edges"], device=device,
        schedule=[(int(h["iterations"] * f), int(h["ls"] * f))
                  for f in h["schedule"]])
    solve_s = time.time() - t0
    for i, (inst, sol, order, ok) in enumerate(zip(insts, sols, orders,
                                                   solved)):
        if ok:
            require(verify_solution(inst, restore_solution(sol, order)),
                    f"phase 28: modular instance {i} is reported solved "
                    "but its restored assignment fails its clauses")
    return {"solved": int(sum(solved)), "count": len(insts),
            "reorder_ms_per_instance": 1e3 * reorder_s / len(insts),
            "solve_s": solve_s, "flips": h["ls"]}


def train_cli_yaml(path, train_json, test_dir, model_dir):
    """config/Train/np-nd-np-uniform.yaml with only TRAIN_CLI_KEYS and the
    paths changed, written line for line (no YAML library needed here)."""
    keys = dict(TRAIN_CLI_KEYS, train_path=[train_json],
                validation_path=[train_json], test_path=[test_dir],
                model_path=model_dir)
    out, seen = [], set()
    with open(os.path.join(ROOT, TRAIN_CLI_YAML)) as f:
        for line in f:
            key = line.split(":", 1)[0]
            if key in keys:
                out.append(f"{key}: {json.dumps(keys[key])}\n")
                seen.add(key)
            else:
                out.append(line)
    require(seen == set(keys), f"phase 29: {TRAIN_CLI_YAML} lacks "
            f"{sorted(set(keys) - seen)}")
    with open(path, "w") as f:
        f.writelines(out)


def numpy_solved(batch, var_pred, np):
    """1.0 for each instance of `batch` whose thresholded prediction
    satisfies all its real clauses, else 0.0, in numpy from the batch's
    edges."""
    def h(x):
        return x.cpu().numpy()
    real = h(batch.edge_mask) > 0
    ev, ec = h(batch.edge_var)[real], h(batch.edge_clause)[real]
    lit = (h(var_pred[:, 0]) > 0.5)[ev] == (h(batch.edge_sign)[real] > 0)
    sat = np.bincount(ec, weights=lit, minlength=batch.num_clauses) > 0
    cm = h(batch.clause_mask) > 0
    unsat = np.bincount(h(batch.clause_batch)[cm], weights=~sat[cm],
                        minlength=batch.batch_size)
    return (unsat == 0).astype(np.float32)


def numpy_test_metrics(seen, np):
    """JAX's test_metrics formula (trainer.py:545-565) in numpy over the
    (solved, label, instance mask) of each batch: [accuracy error,
    recall error], summed over instances / total."""
    from pdp_solver_tpu_torch.train.loss import LOSS_EPS
    err, total = np.zeros(2), 0.0
    for s, lab, mask in seen:
        n = mask.sum()
        l1 = (np.abs(s - lab) * mask).sum() / max(n, 1)
        rec = ((lab * np.abs(s - lab) * mask).sum()
               / max((lab * mask).sum(), LOSS_EPS))
        err += np.array([l1, rec]) * n
        total += n
    return err / max(total, 1)


def cli_train_test(gen_res, torch, np, device="cuda"):
    """Phase 29: satyr_train_test -g (two epochs of 128 generated
    instances at the shipped widths), then -t -l best, on phase 28's
    data. SatTrainer's train_step, test, test_metrics and the checkpoint
    writer are wrapped to time each step (synchronised), keep the test
    results and the trees written, and hold each file's metrics against
    numpy's recomputation from that test's predictions and labels."""
    import tempfile
    from pdp_solver_tpu_torch.cli import satyr_train_test
    from pdp_solver_tpu_torch.train import checkpoint as ckpt
    from pdp_solver_tpu_torch.train import trainer as T
    jd = gen_res["json_dir"]
    low = os.path.join(jd, gen_res["bands"][0])
    step_s, tests, saved, recomputed = [], [], {}, []
    orig = (T.SatTrainer.train_step, T.SatTrainer.test, ckpt.save_params,
            T.SatTrainer.test_metrics)

    def train_step(self, ts, batch):
        t0 = time.time()
        out = orig[0](self, ts, batch)
        if device != "cpu":
            torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        return out

    def test(self, *a, **k):
        res = orig[1](self, *a, **k)
        tests.append(res)
        return res

    def save_params(path_base, tree, name):
        orig[2](path_base, tree, name)
        saved[path_base] = (tree, name)

    def test_metrics(self, loader, replication=1):
        seen, solved_preds = [], self._solved_preds

        def keep(pairs, replication=1):
            for batch, misc, var_pred in solved_preds(pairs, replication):
                seen.append((numpy_solved(batch, var_pred, np),
                             batch.label.cpu().numpy(),
                             batch.instance_mask.cpu().numpy()))
                yield batch, misc, var_pred
        self._solved_preds = keep
        try:
            err = orig[3](self, loader, replication)
        finally:
            del self._solved_preds
        want = numpy_test_metrics(seen, np)
        require(np.allclose(err[:2], want, rtol=0, atol=METRIC_ATOL),
                f"phase 29: test metrics {err[:2].tolist()}, numpy's "
                f"recomputation {want.tolist()}")
        recomputed.append(want.tolist())
        return err

    base = "np-nd-np_pdp-np-nd-np_1.0"
    csvs = [os.path.join(jd, base + s)
            for s in ("-results.csv", "-results-time.csv")]
    n_json = len([f for f in os.listdir(jd) if f.endswith(".json")])
    out = {}
    T.SatTrainer.train_step, T.SatTrainer.test = train_step, test
    T.SatTrainer.test_metrics = test_metrics
    ckpt.save_params = save_params
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = os.path.join(tmp, "train.yaml")
            models = os.path.join(tmp, "models")
            train_cli_yaml(cfg, low, jd, models)
            flags = ["-c"] if device == "cpu" else []
            for run, argv in (("train", [cfg, "-g"] + flags),
                              ("test", [cfg, "-t", "-l", "best"] + flags)):
                t0 = time.time()
                satyr_train_test.main(argv)
                out[f"{run}_s"] = time.time() - t0
                # the results CSV holds each file's recall error, the
                # time CSV its seconds
                recall = {p: float(e[1, 0]) for p, e, _ in tests[-1]}
                for c in csvs:
                    with open(c, newline="") as f:
                        rows = [r for r in csv.reader(f) if r]
                    require(len(rows) == n_json, f"phase 29: {run} wrote "
                            f"{len(rows)} rows to {os.path.basename(c)}")
                    os.remove(c)
                    if c == csvs[0]:
                        for path, value in rows:
                            require(abs(float(value) - recall[path])
                                    <= METRIC_ATOL, f"phase 29: {run}'s "
                                    f"CSV has {value} for {path}, its "
                                    f"test {recall[path]}")
            root = os.path.join(models, "pdp-np-nd-np", "1.0")
            for part in ("best", "last"):
                d = os.path.join(root, part)
                require(os.path.exists(os.path.join(d, "pdp-np-nd-np.npz")),
                        f"phase 29: no {part}/pdp-np-nd-np.npz")
                tree, name = saved[os.path.relpath(d)]
                back = ckpt.load_params(d, tree, name)
                for (k, a), (_, b) in zip(ckpt._flatten(tree),
                                          ckpt._flatten(back)):
                    require(np.array_equal(a, b), f"phase 29: {part} leaf "
                            f"{k} does not read back bit for bit")
            for arr in ("losses", "errors"):
                x = np.load(os.path.join(root, "best", arr + ".npy"))
                require(np.isfinite(x).all(), f"phase 29: {arr}.npy not "
                        "finite")
                out[arr] = x.reshape(-1).tolist()
    finally:
        T.SatTrainer.train_step, T.SatTrainer.test = orig[:2]
        T.SatTrainer.test_metrics = orig[3]
        ckpt.save_params = orig[2]
    # every metric was held above against numpy's recomputation of JAX's
    # formula (trainer.py test_metrics); its range: with labels in {0, 1}
    # accuracy and recall lie in [0, 1]; generate's one-sided labels are
    # {1, -1} (-1: unknown), which put the L1 error |solved - label| in
    # [0, 2] (accuracy in [-1, 1]) and the recall's denominator at the sum
    # of the labels, so there only the accuracy's range is held
    from pdp_solver_tpu_torch.fg.jsonfmt import read_json_dataset
    metrics = []
    for res in tests:
        for path, err, _ in res:
            acc, rec = 1 - float(err[0, 0]), 1 - float(err[1, 0])
            binary = {r[4] for r in read_json_dataset(path)} <= {0.0, 1.0}
            lo = 0.0 if binary else -1.0
            require(np.isfinite(acc) and np.isfinite(rec)
                    and lo <= acc <= 1 and (0 <= rec <= 1 or not binary),
                    f"phase 29: {path}: accuracy {acc}, recall {rec}")
            metrics.append((os.path.basename(path), acc, rec))
    # test_metrics also serves the training run's validation
    require(len(metrics) == 2 * n_json <= len(recomputed),
            f"phase 29: {len(metrics)} test results, {len(recomputed)} "
            "recomputed")
    out.update(steps=len(step_s), metrics=metrics,
               ms_per_step=1e3 * float(np.median(step_s)) if step_s else 0)
    return out


# ---------------------------------------------------------------------------
# phases 30-33: multi-card execution (parallel/, utils/resilient.py) with
# ranks that share the one card (gloo, their tensors staged through the
# host), and one NCCL rank


def kernel_counts():
    """The launches of each kernel of the port since the last reset_counts
    (kernels 1-10 of PERF.md's table; 1 and 2 summed over functors)."""
    from pdp_solver_tpu_torch.ops import (
        fused, reduce, reduce2d, sp_sweep, verify, walksat)
    return {"k1": sum(fused.fused_edge_pass.launches_by_fn.values()),
            "k2": sum(fused.chained_edge_pass.launches_by_fn.values()),
            "k3": walksat.walksat_walk.launches,
            "k4": reduce.segment_sum_cols.launches,
            "k6": (reduce2d.segment_sum_2d.launches
                   + reduce2d.segment_sum_2d.launches_bf16),
            "k7": (reduce2d.gather_2d.launches
                   + reduce2d.gather_2d.launches_bf16),
            "k9": sp_sweep.sp_full_sweep.launches,
            "k10": verify.verify_and_masks.launches}


def require_kernels(counts, kernels, what):
    for k in kernels:
        require(counts.get(k, 0) > 0, f"{what} never launched kernel "
                f"{k[1:]}: {counts}")


def spawn_ranks(target, world, payload, backend=None):
    """target(rank, world, payload) of this script in `world` processes on
    the card (torch.multiprocessing, spawn), joined by a process group
    through a file; their results in rank order. A rank that fails, or a
    launch that outlasts RANK_TIMEOUT, fails the phase; every process is
    stopped before this returns."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(
            _rank_main, args=(world, d, target, payload, backend),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + RANK_TIMEOUT
        try:
            while not ctx.join(timeout=2):
                if time.time() > deadline:
                    raise SmokeFailure(f"{target}: the ranks still ran "
                                       f"after {RANK_TIMEOUT} s")
        except SmokeFailure:
            raise
        except Exception as e:
            raise SmokeFailure(f"{target}: a rank failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        return [torch.load(os.path.join(d, f"out-{r}.pt"),
                           weights_only=False) for r in range(world)]


def _rank_main(rank, world, d, target, payload, backend):
    sys.path.insert(0, ROOT)
    import torch
    from pdp_solver_tpu_torch.parallel import mesh
    mesh.distributed_initialize(
        backend=backend, init_method="file://" + os.path.join(d, "pg"),
        world_size=world, rank=rank, device="cuda")
    try:
        res = globals()[target](rank, world, payload)
        mesh.barrier()
    finally:
        mesh.destroy()
    torch.save(res, os.path.join(d, f"out-{rank}.pt"))


def _path_run(fn):
    """fn() with the launch counts and the collectives' counters set to 0
    just before and read just after; (result, seconds, kernel counts,
    per-row counts, collectives)."""
    import torch
    from pdp_solver_tpu_torch.parallel import mesh
    torch.cuda.synchronize()
    reset_counts()
    mesh.reset_stats()
    t0 = time.time()
    res = fn()
    torch.cuda.synchronize()
    return (res, time.time() - t0, kernel_counts(), read_counts(),
            dict(mesh.STATS))


def _verify(insts, batch, pred, np):
    """Every instance's solution (pred > 0.5) against numpy, and the
    solver's flags against that: the count numpy verifies."""
    from pdp_solver_tpu_torch.solvers.compact import instance_slices
    from pdp_solver_tpu_torch.train.loss import cnf_evaluate
    from pdp_solver_tpu_torch.utils.headline import verify_solution
    flags = cnf_evaluate(batch, pred)[0].cpu().numpy()
    p = pred[:, 0].cpu().numpy()
    ok = [verify_solution(inst, (p[v:v + n] > 0.5).astype(np.float32))
          for inst, (v, _, _, n, _, _) in zip(insts, instance_slices(insts))]
    require(ok == [bool(f > 0.5) for f in flags[:len(insts)]],
            "a solution the solver reports disagrees with numpy")
    return sum(ok)


def rank_serve(rank, world, p):
    """Phase 30 on one rank: the data-parallel solve (make_parallel_solve)
    of this rank's share of the shared set, then the serial forward of the
    same instances from the same state and generator state; p-d-p also
    the replica-parallel solve of the whole set on a (1, world) mesh."""
    import numpy as np
    import torch
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.parallel import mesh
    from pdp_solver_tpu_torch.solvers.compact import RETRIES
    from pdp_solver_tpu_torch.train.loss import cnf_evaluate
    from pdp_solver_tpu_torch.utils import neural
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    from pdp_solver_tpu_torch.utils.headline import HEADLINE, headline_solver
    insts = make_ksat_set()
    per = len(insts) // world
    mine = insts[rank * per:(rank + 1) * per]
    out = {"retries": 0}
    for model in p["models"]:
        if model == "p-d-p":
            solver, params = headline_solver(), {}
            iters, R = HEADLINE["iterations"], DP_PDP_REPLICATION
        else:
            solver = neural.np_nd_np_solver()
            params = neural.np_nd_np_params()
            iters, R = DP_NP_ND_NP_ITERATIONS, 1
        batch = pack_instances(mine, device="cuda")
        gen = torch.Generator().manual_seed(DP_SEED + rank)
        state = solver.get_init_state(gen, batch, randomized=True,
                                      replication=R)
        g0 = gen.get_state()
        solve = mesh.make_parallel_solve(solver, iters, replication=R)
        (pred, frac), secs, kc, rc, coll = _path_run(
            lambda: solve(params, gen, batch, state))
        gen.set_state(g0)
        (ser, _), _ = solver.forward(params, gen, batch, state, iters,
                                     check_termination=True, replication=R)
        flags = [cnf_evaluate(batch, x)[0].cpu().numpy()
                 for x in (pred, ser)]
        out[model] = dict(
            frac=float(frac), solved=_verify(mine, batch, pred, np),
            wall_s=secs, kernels=kc, launches=rc, collectives=coll,
            max_diff=float((pred - ser).abs().max()),
            flags_equal=bool((flags[0] == flags[1]).all()))
    if p.get("replica"):
        batch = pack_instances(insts, device="cuda")
        m = mesh.make_mesh_2d(1, world)
        solver = headline_solver()
        solve = mesh.make_replica_parallel_solve(
            solver, HEADLINE["iterations"], mesh=m)
        gen = torch.Generator().manual_seed(DP_SEED + 100 + rank)
        (sel, frac, best), secs, kc, rc, coll = _path_run(
            lambda: solve({}, gen, batch))
        out["replica"] = dict(
            frac=float(frac), solved=_verify(insts, batch, sel, np),
            wall_s=secs, kernels=kc, launches=rc, collectives=coll,
            chosen=np.bincount(best.cpu().numpy()[:len(insts)],
                               minlength=world).tolist())
    out["retries"] = RETRIES["count"]
    return out


def rank_train(rank, world, p):
    """Phase 31 on one rank: one flagship-recipe step of the data-parallel
    train step on segment `rank`, rank 0 also a serial step on the mean
    of the two segments' gradients from the same generators; then timed
    and profiled steps."""
    import itertools
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pdp_solver_tpu_torch.parallel import mesh
    from pdp_solver_tpu_torch.train.trainer import SatTrainer
    from pdp_solver_tpu_torch.utils import training
    from pdp_solver_tpu_torch.utils.profile_solve import device_kernels
    cfg = training.FLAGSHIP_RECIPE
    segs = [s[0] for s in itertools.islice(training.flagship_segments(0),
                                           world)]

    def gen(r):
        return torch.Generator().manual_seed(TRAIN_DP_SEED + r)
    tr = SatTrainer(cfg, seed=0, device="cuda")
    ts = tr.init_train_state()
    step = mesh.make_parallel_train_step(tr)
    (ts, loss), secs, kc, rc, coll = _path_run(
        lambda: step(ts, segs[rank], generator=gen(rank)))
    out = dict(loss=float(loss), first_s=secs, kernels=kc, launches=rc,
               collectives=coll)
    if rank == 0:
        other = SatTrainer(cfg, seed=0, device="cuda")
        other.params.train()
        other.loss(other.params, segs[1], torch.zeros((), device="cuda"),
                   generator=gen(1)).backward()
        g1 = [q.grad for q in other.params.parameters()]

        def mean_with_other(grads, loss0):
            for g, h in zip(grads, g1):
                if h is not None:
                    g.add_(h)
                g.div_(2.0)
            return loss0
        ser = SatTrainer(cfg, seed=0, device="cuda")
        ser.train_step(ser.init_train_state(), segs[0], generator=gen(0),
                       reduce_grads=mean_with_other)
        with torch.no_grad():
            out["max_param_diff"] = max(
                float((x - y).abs().max()) for x, y in zip(
                    ts.params.parameters(), ser.params.parameters()))
    mesh.barrier()
    walls = []
    for _ in range(TRAIN_DP_TIMED):
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.time()
        ts, _ = step(ts, segs[rank], generator=gen(rank))
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    mesh.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts, _ = step(ts, segs[rank], generator=gen(rank))
        torch.cuda.synchronize()
    out["ms_per_step"] = 1e3 * sorted(walls)[len(walls) // 2]
    out["busy_ms"] = sum(us for us, _ in device_kernels(prof).values()) / 1e3
    return out


def giant_ksat(np, n, m, k, seed):
    """A random k-SAT instance's (graph_map [2, m k], signs [m k]): k
    distinct variables a clause, vectorised for millions of clauses."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, n, size=(m, k))
    while True:
        s = np.sort(v, axis=1)
        bad = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not bad.any():
            break
        v[bad] = rng.integers(0, n, size=(int(bad.sum()), k))
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), size=m * k)
    gmap = np.stack([v.reshape(-1), np.repeat(np.arange(m), k)])
    return gmap.astype(np.int64), signs


def edge_sp_run(np, world, rank):
    """The giant instance's SP marginals after EDGE_SP_SWEEPS sweeps on
    shard `rank` of `world`, uniform messages: (score, ms a sweep, kernel
    counts, row counts, collectives)."""
    import torch
    from pdp_solver_tpu_torch.parallel import edge_shard as es
    n, m = EDGE_SP_N, int(EDGE_SP_N * EDGE_SP_ALPHA)
    gmap, signs = giant_ksat(np, n, m, 4, EDGE_SP_SEED)
    g = es.shard_instance(n, m, gmap, signs, world)
    shard = es.local_shard(g, rank, "cuda")
    v0, f0 = es.init_states(g, None, randomized=False)
    v0, f0 = v0[rank].cuda(), f0[rank].cuda()
    es.make_edge_sharded_sp(g, 1)(shard, v0, f0)          # warm-up
    (score, _), secs, kc, rc, coll = _path_run(
        lambda: es.make_edge_sharded_sp(g, EDGE_SP_SWEEPS)(shard, v0, f0))
    return score.cpu().numpy(), secs * 1e3 / EDGE_SP_SWEEPS, kc, rc, coll


def edge_solve_run(world, rank):
    """Shard `rank` of `world` of the edge-sharded p-d-p solve of the first
    EDGE_SOLVE_COUNT instances of the shared set (EDGE_SOLVE), from the
    generator seeded EDGE_SOLVE_SEED."""
    import torch
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.parallel import edge_shard as es
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    insts = make_ksat_set()[:EDGE_SOLVE_COUNT]
    g = es.shard_batch(pack_instances(insts, device="cpu"), world)
    gen = torch.Generator().manual_seed(EDGE_SOLVE_SEED)
    v, f = es.init_states(g, gen, randomized=True)
    run = es.make_edge_sharded_solver(g, **EDGE_SOLVE)
    (sol, solved, it, _), secs, kc, rc, coll = _path_run(
        lambda: run(es.local_shard(g, rank, "cuda"), v[rank].cuda(),
                    f[rank].cuda(), gen))
    return dict(sol=sol.cpu().numpy(), solved=solved.cpu().numpy(),
                iterations=it, solve_s=secs, solve_kernels=kc,
                solve_launches=rc, solve_collectives=coll)


def rank_edge(rank, world, p):
    """Phase 32 on one rank: its edge shard of the giant instance's SP
    sweeps, then its shard of the edge-sharded p-d-p solve."""
    import numpy as np
    score, ms, kc, rc, coll = edge_sp_run(np, world, rank)
    out = dict(score=score, ms_per_sweep=ms, sp_kernels=kc, sp_launches=rc,
               sp_collectives=coll)
    out.update(edge_solve_run(world, rank))
    return out


def rank_mesh(rank, world, p):
    """Phase 33 on one rank: parallel_compacting_solve of the shared set
    at the headline solver settings (one attempt)."""
    import torch
    from pdp_solver_tpu_torch.parallel import compact_mesh as cm
    from pdp_solver_tpu_torch.solvers.compact import RETRIES
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    from pdp_solver_tpu_torch.utils.headline import HEADLINE, headline_solver
    insts = make_ksat_set()
    h = HEADLINE
    (sols, solved, stats), secs, kc, rc, coll = _path_run(
        lambda: cm.parallel_compacting_solve(
            headline_solver(), {}, torch.Generator().manual_seed(MESH_SEED),
            insts, h["iterations"], ls_iterations=h["ls"], chunk=h["chunk"],
            min_edges=h["min_edges"], device="cuda"))
    return dict(sols=sols, solved=solved, stats=stats, wall_s=secs,
                kernels=kc, launches=rc, collectives=coll,
                retries=RETRIES["count"])


class _Interrupted:
    """A solver whose forward(finalize=False) ends the process
    (os._exit, no clean-up) before chunk `kill_after + 1`, or raises a
    RuntimeError at chunk `fault_at`."""

    def __init__(self, inner, kill_after=None, fault_at=None):
        self._inner, self._kill, self._fault = inner, kill_after, fault_at
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def forward(self, *args, **kw):
        if not kw.get("finalize", True):
            self.calls += 1
            if self._kill is not None and self.calls > self._kill:
                os._exit(KILLED_RC)
            if self.calls == self._fault:
                raise RuntimeError("injected fault")
        return self._inner.forward(*args, **kw)


def resilient_inputs():
    import torch
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    from pdp_solver_tpu_torch.utils.headline import headline_solver
    batch = pack_instances(make_ksat_set(), device="cuda")
    solver = headline_solver()
    state = solver.get_init_state(torch.Generator().manual_seed(5), batch,
                                  randomized=True)
    return solver, batch, state


def resilient_run(solver, batch, state, **kw):
    import torch
    from pdp_solver_tpu_torch.utils.resilient import resilient_solve
    stats = {}
    pred, _ = resilient_solve(solver, {}, torch.Generator().manual_seed(7),
                              batch, state, RESILIENT_ITERATIONS,
                              chunk=RESILIENT_CHUNK, stats=stats, **kw)
    return pred, stats


def resilient_process(ckpt, kill_after, out):
    """Phase 33's resilient solve in a process of its own: killed after
    `kill_after` chunks (its checkpoint left behind), or (None) resumed
    from the checkpoint to the end, its prediction saved to `out`."""
    sys.path.insert(0, ROOT)
    import torch
    solver, batch, state = resilient_inputs()
    if kill_after is not None:
        solver = _Interrupted(solver, kill_after=kill_after)
    pred, stats = resilient_run(solver, batch, state, checkpoint_path=ckpt)
    torch.save({"pred": pred.cpu(), "stats": stats}, out)


def resilient_check(torch, np):
    """Phase 33, second part: the resilient solve uninterrupted, with an
    injected fault, and killed then resumed in two processes."""
    import tempfile
    import torch.multiprocessing as mp
    from pdp_solver_tpu_torch.solvers.compact import RETRIES
    solver, batch, state = resilient_inputs()
    t0 = time.time()
    ref, st = resilient_run(solver, batch, state)
    torch.cuda.synchronize()
    wall = time.time() - t0
    require(st["retries"] == 0, f"phase 33: {st['retries']} retries "
            "without a fault")
    before = RETRIES["count"]
    got, fst = resilient_run(_Interrupted(solver, fault_at=2), batch, state)
    require(fst["retries"] == 1 and RETRIES["count"] == before + 1,
            f"phase 33: the injected fault gave {fst['retries']} retries")
    require(torch.equal(got, ref), "phase 33: the recovered solve differs "
            "from the uninterrupted one")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        ckpt, out = os.path.join(d, "solve.ck"), os.path.join(d, "out.pt")
        codes = []
        for kill in (RESILIENT_STOP, None):
            proc = ctx.Process(target=resilient_process,
                               args=(ckpt, kill, out))
            proc.start()
            proc.join(RANK_TIMEOUT)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            codes.append(proc.exitcode)
            if kill is not None:
                require(proc.exitcode == KILLED_RC and os.path.exists(ckpt),
                        f"phase 33: the first process ended with "
                        f"{proc.exitcode}, checkpoint "
                        f"{'kept' if os.path.exists(ckpt) else 'missing'}")
                done = torch.load(ckpt, weights_only=False)["done"]
                require(done == RESILIENT_STOP * RESILIENT_CHUNK,
                        f"phase 33: the checkpoint holds {done} iterations")
        require(codes[1] == 0, f"phase 33: the resuming process ended with "
                f"{codes[1]}")
        res = torch.load(out, weights_only=False)
        require(not os.path.exists(ckpt), "phase 33: the checkpoint was not "
                "removed at the end")
    require(torch.equal(res["pred"], ref.cpu()), "phase 33: the resumed "
            "solve differs from the uninterrupted one")
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    return dict(solved=_verify(make_ksat_set(), batch, ref, np),
                wall_s=wall,
                codes=codes, done=done,
                resumed_retries=res["stats"]["retries"])


def satyr_torchrun(lines27):
    """Phase 30, last part: satyr under torchrun, DP_RANKS ranks sharing
    the card, with phase 27's arguments: phase 27's lines."""
    import tempfile
    argv = [CLI_PDP_YAML, CLI_SAMPLE, "80", "-w", "100", "-s", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(DP_RANKS), "-m",
             "pdp_solver_tpu_torch.cli.satyr"] + argv + ["-o", out],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=RANK_TIMEOUT)
        wall = time.time() - t0
        require(proc.returncode == 0, f"phase 30: satyr under torchrun "
                f"exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            lines = f.read().splitlines()
    require(lines == lines27, "phase 30: satyr under torchrun wrote other "
            "lines than phase 27's")
    return wall


def sum_counts(parts):
    """Row counts summed over ranks (integer entries)."""
    out = {}
    for c in parts:
        for k, v in c.items():
            if isinstance(v, int):
                out[k] = out.get(k, 0) + v
    return out


def sum_kernels(parts):
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def reset_counts():
    from pdp_solver_tpu_torch.utils.profile_solve import reset_launches
    reset_launches()


def read_counts():
    from pdp_solver_tpu_torch.ops import (
        fused, reduce, reduce2d, sp_sweep, verify, walksat)
    launches = dict(fused.fused_edge_pass.launches_by_fn)
    launches.update(fused.chained_edge_pass.launches_by_fn)
    launches["walksat_walk"] = walksat.walksat_walk.launches
    launches["segment_sum_2d"] = reduce2d.segment_sum_2d.launches
    launches["gather_2d"] = reduce2d.gather_2d.launches
    launches["segment_sum_2d[bf16]"] = reduce2d.segment_sum_2d.launches_bf16
    launches["gather_2d[bf16]"] = reduce2d.gather_2d.launches_bf16
    launches["segment_sum_cols"] = reduce.segment_sum_cols.launches
    launches["segment_sum_cols_by_form"] = dict(
        reduce.segment_sum_cols.launches_by_form)
    launches["sp_full_sweep"] = sp_sweep.sp_full_sweep.launches
    launches["sp_full_sweep[login]"] = (
        sp_sweep.sp_full_sweep.launches_by_form.get("login", 0))
    launches["verify_and_masks"] = verify.verify_and_masks.launches
    return launches


def require_bf16_path(launches, what, gather):
    """A bf16 path went through kernels 6 (and 7) on bf16 rows and never
    through their f32 instantiations."""
    require(launches["segment_sum_2d[bf16]"] > 0
            and (launches["gather_2d[bf16]"] > 0 or not gather),
            f"{what} in bf16 never launched the bf16 kernels 6/7")
    require(launches["segment_sum_2d"] == 0 and launches["gather_2d"] == 0,
            f"{what} in bf16 launched an f32 [E, d] kernel")


def run_path(solve):
    """One path with every launch count set to 0 just before and read
    just after."""
    reset_counts()
    try:
        res = solve()
    except RuntimeError as e:
        raise SmokeFailure(str(e))
    return res, read_counts()


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pdp_solver_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import _build
    from pdp_solver_tpu_torch.utils.benchdata import (
        SHARED_SET_FINGERPRINT, dataset_fingerprint, make_ksat_set)

    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    try:
        path, secs, _ = _build.build(force=True)
        log(f"phase 1 build: one nvcc call, {secs:.1f} s -> "
            f"{os.path.relpath(path, ROOT)}")

        insts = make_ksat_set()
        fp = dataset_fingerprint(insts)
        require(fp == SHARED_SET_FINGERPRINT, f"fingerprint {fp}")
        batch = pack_instances(insts, device="cuda")
        log(f"shared set {fp}: E={batch.num_edges} ({batch.num_real_edges} "
            f"real) V={batch.num_vars} F={batch.num_clauses} "
            f"B={batch.batch_size}")
        rows = check_kernels(batch, torch, np)
        for name, errs in check_kernels_replicated(insts, torch).items():
            rows[name]["replicated_max_abs_err"] = errs
        for name, numbers in check_folds(insts, torch).items():
            rows[name].update(numbers)
        rows.update(check_reduce2d(batch, torch))
        rows.update(check_reduce2d_bf16(
            batch, pack_instances(insts[:8], device="cuda"), torch))
        from pdp_solver_tpu_torch.utils.bench_kernels import hub_batch
        walk2d = check_sum2d_walk(
            {"shared": batch,
             "compacted": pack_instances(insts[:8], device="cuda"),
             "hub": hub_batch()}, torch)
        rows["segment_sum_2d"]["walk_cases"] = {
            k: v for k, v in walk2d.items() if "float32" in k}
        rows["segment_sum_2d[bf16]"]["walk_cases"] = {
            k: v for k, v in walk2d.items() if "bfloat16" in k}
        rows.update(check_reduce(batch, torch, np))
        for name, per_case in check_walk(insts, torch, np).items():
            rows[name]["walk_cases"] = per_case
        rows.update(check_walksat(insts, torch, np))
        rows.update(check_walksat_replicated(insts, torch, np))
        rows.update(check_sp_sweep(
            batch, pack_instances(insts[:8], device="cuda"), torch))
        del batch
        rows.update(check_verify(insts, torch, np))
        log("phase 2 kernel checks: all kernels match their plain versions")

        from pdp_solver_tpu_torch.utils.headline import solve_headline
        res, launches = run_path(lambda: solve_headline(insts, seed=0))
        frac = res["solved_fraction"]
        log(f"phase 3 p-d-p path: solved {frac:.4f} ({res['solved']}/"
            f"{len(insts)}, verified with numpy) in {res['wall_s']:.2f} s; "
            f"attempts {res['attempt_solved']}, pdp {res['pdp_wall_s']} s, "
            f"walksat {res['ls_wall_s']} s, {res['compactions']} "
            "compactions")
        log(f"launches on the p-d-p path: {json.dumps(launches)}")
        require(frac >= MIN_SOLVED,
                f"solved fraction {frac} < {MIN_SOLVED}")
        # JAX's chip default: every fold on, no split pass left in the loop
        for name in FOLDED_PDP_KERNELS:
            require(launches.get(name, 0) > 0,
                    f"the folded p-d-p path never launched {name}")
        require(not any(launches.get(n, 0) for n in SPLIT_PDP_KERNELS),
                "the folded p-d-p path launched a split pass: "
                f"{ {n: launches.get(n, 0) for n in SPLIT_PDP_KERNELS} }")

        t0 = time.time()
        with switches(PDP_SWEEP_DEC_FOLD="off"):
            ures, ulaunches = run_path(lambda: solve_headline(insts, seed=0))
        log(f"phase 34 p-d-p unfolded (PDP_SWEEP_DEC_FOLD=off): solved "
            f"{ures['solved_fraction']:.4f} ({ures['solved']}/{len(insts)}, "
            f"verified with numpy; phase 3, folded: {res['solved']}) in "
            f"{ures['wall_s']:.2f} s; attempts {ures['attempt_solved']}, pdp "
            f"{ures['pdp_wall_s']} s, walksat {ures['ls_wall_s']} s")
        log(f"launches on the unfolded p-d-p path: {json.dumps(ulaunches)}")
        require(ures["solved_fraction"] >= MIN_SOLVED, f"the unfolded p-d-p "
                f"path solved {ures['solved_fraction']} < {MIN_SOLVED}")
        for name in SPLIT_PDP_KERNELS:
            require(ulaunches.get(name, 0) > 0,
                    f"the unfolded p-d-p path never launched {name}")
        require(not any(ulaunches.get(n, 0) for n in FOLD_KERNELS),
                f"the unfolded p-d-p path launched a fold: {ulaunches}")
        # the decimator fold alone, then with the mask fold: the same
        # bits as the split passes (phase 2), so the unfolded run's solve
        fold_paths = {}
        for fn, off in (("sp_chain_dec", "PDP_SWEEP_MASK_FOLD"),
                        ("sp_chain_mask", "PDP_SWEEP_VERIFY_FOLD")):
            with switches(**{off: "off"}):
                vres, fold_paths[fn] = run_path(
                    lambda: solve_headline(insts, seed=0))
            log(f"phase 34 p-d-p with {off}=off: solved {vres['solved']}/"
                f"{len(insts)} (verified with numpy; unfolded "
                f"{ures['solved']}) in {vres['wall_s']:.2f} s; launches "
                f"{json.dumps(fold_paths[fn])}")
            require(vres["solved"] == ures["solved"], f"p-d-p with {off}="
                    f"off solved {vres['solved']}, the unfolded run "
                    f"{ures['solved']}")
            require(fold_paths[fn].get(fn, 0) > 0
                    and not fold_paths[fn].get("sp_chain_maskv", 0),
                    f"p-d-p with {off}=off never launched {fn}")
        fcmp = card_vs_cpu(insts, torch, replication=1)
        log(f"phase 34 folded forward card vs cpu (PDP_FUSED_PASS=on on the "
            f"cpu): every state column on every edge within rtol "
            f"{FLOAT_TOL['rtol']} / atol {FLOAT_TOL['atol']} (max abs err "
            f"{fcmp['state_max_abs_err']:.3g}) and the carry exact after 1 "
            f"iteration; after {REP_CMP_ITERATIONS}, "
            f"{fcmp['var_diff_share']:.4%} of the variables differ "
            f"({fcmp['inactive_vars']} inactive on the CPU), "
            f"{fcmp['flag_diffs']} instance flags differ; phase 34 in "
            f"{time.time() - t0:.1f} s")

        from pdp_solver_tpu_torch.utils.neural import solve_np_nd_np
        require(not torch.backends.cuda.matmul.allow_tf32,
                "TF32 matrix products are on")
        nres, nlaunches = run_path(lambda: solve_np_nd_np(insts, seed=0))
        nfrac = nres["solved_fraction"]
        log(f"phase 4 np-nd-np path: solved {nfrac:.4f} ({nres['solved']}/"
            f"{len(insts)}, verified with numpy) in {nres['wall_s']:.2f} s; "
            f"loop {nres['loop_wall_s']} s, walksat {nres['ls_wall_s']} s, "
            f"{nres['chunks']} chunks, {nres['compactions']} compactions, "
            f"progress {nres['progress']}")
        log(f"launches on the np-nd-np path: {json.dumps(nlaunches)}")
        require(nfrac >= MIN_SOLVED_NEURAL,
                f"np-nd-np solved fraction {nfrac} < {MIN_SOLVED_NEURAL}")

        from pdp_solver_tpu_torch.utils.classical import (
            solve_reinforce, solve_walk_sat)
        wres, wlaunches = run_path(lambda: solve_walk_sat(insts, seed=0))
        log(f"phase 5 walk-sat path: solved {wres['solved']}/{len(insts)} "
            f"(verified with numpy) in {wres['wall_s']:.2f} s; walksat "
            f"{wres['ls_wall_s']} s")
        log(f"launches on the walk-sat path: {json.dumps(wlaunches)}")
        require(wres["solved"] >= MIN_SOLVED_WALK_SAT,
                f"walk-sat solved {wres['solved']} < {MIN_SOLVED_WALK_SAT}")
        require(wlaunches["walksat_walk"] > 0,
                "walk-sat never launched walksat_walk")

        rres, rlaunches = run_path(lambda: solve_reinforce(insts, seed=0))
        log(f"phase 6 reinforce path: solved {rres['solved']}/{len(insts)} "
            f"(verified with numpy; {rres['loop_solved']} by the REINFORCE "
            f"loop before WalkSAT) in {rres['wall_s']:.2f} s; loop "
            f"{rres['loop_wall_s']} s, walksat {rres['ls_wall_s']} s, "
            f"{rres['chunks']} chunks, progress {rres['progress']}")
        log(f"launches on the reinforce path: {json.dumps(rlaunches)}")
        require(rres["solved"] >= MIN_SOLVED_REINFORCE,
                f"reinforce solved {rres['solved']} < "
                f"{MIN_SOLVED_REINFORCE}")
        cmp = reinforce_card_vs_cpu(insts, torch)
        log(f"phase 6 reinforce card vs cpu: forces, predictions and flags "
            f"equal after 1 iteration except at {cmp['score_ties']} "
            f"variables with |score| < {SCORE_TIE}; SP messages max abs err "
            f"{cmp['message_max_abs_err']:.3g}; "
            f"{cmp['force_diff_share_10']:.4%} of the forces differ after "
            "10 iterations")

        # the folds bypass kernel 9's sweep, as in the JAX package
        with switches(PDP_SP_SWEEP="on", PDP_SWEEP_DEC_FOLD="off"):
            sres, slaunches = run_path(lambda: solve_headline(insts, seed=0))
        sfrac = sres["solved_fraction"]
        log(f"phase 7 p-d-p with PDP_SP_SWEEP=on PDP_SWEEP_DEC_FOLD=off: "
            f"solved {sfrac:.4f} "
            f"({sres['solved']}/{len(insts)}, verified with numpy; the two-"
            f"launch unfolded run, phase 34, solved {ures['solved']}: "
            f"{'reproduced' if sres['solved'] == ures['solved'] else 'not reproduced'}"
            f") in {sres['wall_s']:.2f} s")
        log(f"launches on the p-d-p sweep path: {json.dumps(slaunches)}")
        require(sfrac >= MIN_SOLVED, f"p-d-p with the one-launch sweep "
                f"solved {sfrac} < {MIN_SOLVED}")
        # one sweep and one decimator pass per iteration, no two-launch
        # sweep left
        require(slaunches["sp_full_sweep"] == slaunches.get("smax_scorer")
                and slaunches.get("sp_chain", 0) == 0
                and slaunches.get("sp_pass_c", 0) == 0,
                "the one-launch sweep did not replace every sweep: "
                f"{slaunches['sp_full_sweep']} launches for "
                f"{slaunches.get('smax_scorer')} iterations")

        from pdp_solver_tpu_torch.utils.neural import solve_p_nd_np
        pres, plaunches = run_path(lambda: solve_p_nd_np(insts, seed=0))
        log(f"phase 8 p-nd-np path: solved {pres['solved']}/{len(insts)} "
            f"(verified with numpy) in {pres['wall_s']:.2f} s; loop "
            f"{pres['loop_wall_s']} s, walksat {pres['ls_wall_s']} s, "
            f"{pres['chunks']} chunks, {pres['compactions']} compactions, "
            f"progress {pres['progress']}")
        log(f"launches on the p-nd-np path: {json.dumps(plaunches)}")
        require(pres["solved"] >= MIN_SOLVED_P_ND_NP,
                f"p-nd-np solved {pres['solved']} < {MIN_SOLVED_P_ND_NP}")
        for name in P_ND_NP_KERNELS:
            require(plaunches.get(name, 0) > 0,
                    f"p-nd-np never launched {name}")

        os.environ.update(PDP_SP_SWEEP="on", PDP_VERIFY_MASKS="on")
        try:
            qres, qlaunches = run_path(lambda: solve_p_nd_np(insts, seed=0))
        finally:
            os.environ.pop("PDP_SP_SWEEP")
            os.environ.pop("PDP_VERIFY_MASKS")
        log(f"phase 9 p-nd-np with PDP_SP_SWEEP=on PDP_VERIFY_MASKS=on: "
            f"solved {qres['solved']}/{len(insts)} (verified with numpy; "
            f"phase 8 solved {pres['solved']}: "
            f"{'reproduced' if qres['solved'] == pres['solved'] else 'not reproduced'}"
            f") in {qres['wall_s']:.2f} s; loop {qres['loop_wall_s']} s, "
            f"progress {qres['progress']}")
        log(f"launches on the p-nd-np one-launch path: "
            f"{json.dumps(qlaunches)}")
        require(qres["solved"] >= MIN_SOLVED_P_ND_NP,
                f"p-nd-np with the one-launch kernels solved "
                f"{qres['solved']} < {MIN_SOLVED_P_ND_NP}")
        # one login sweep and one verification per iteration; no two-launch
        # sweep and no split verification left in the loop
        n_sweep = qlaunches["sp_full_sweep[login]"]
        require(n_sweep > 0 and n_sweep == qlaunches["verify_and_masks"]
                and qlaunches.get("sp_chain_login", 0) == 0
                and qlaunches.get("em_ae", 0) == 0,
                "the one-launch kernels did not replace every sweep and "
                f"verification: {n_sweep} sweeps, "
                f"{qlaunches['verify_and_masks']} verifications, "
                f"{qlaunches.get('sp_chain_login', 0)} sp_chain_login, "
                f"{qlaunches.get('em_ae', 0)} em_ae")

        from pdp_solver_tpu_torch.utils.neural import (
            np_d_np_3sat_band, np_d_np_params, solve_np_d_np)
        dparams = np_d_np_params()
        dres, dlaunches = run_path(lambda: solve_np_d_np(
            insts, seed=0, params=dparams))
        log(f"phase 10 np-d-np path: solved {dres['solved']}/{len(insts)} "
            f"(verified with numpy; the JAX package's records: "
            f"{JAX_NP_D_NP} of {len(insts)}, seeds 0-2) in "
            f"{dres['wall_s']:.2f} s; loop {dres['loop_wall_s']} s, walksat "
            f"{dres['ls_wall_s']} s, {dres['chunks']} chunks, "
            f"{dres['compactions']} compactions, progress "
            f"{dres['progress']}")
        log(f"launches on the np-d-np path: {json.dumps(dlaunches)}")
        for name in NP_D_NP_KERNELS:
            require(dlaunches.get(name, 0) > 0,
                    f"np-d-np never launched {name}")

        band = np_d_np_3sat_band(dparams)
        fresh = np_d_np_3sat_band(np_d_np_params(trained=False, seed=0))
        log(f"phase 11 np-d-np on the medium 3-SAT band (48 instances, n 60,"
            f" alpha 3.5, 300 iterations, decimation only): trained "
            f"{band['solved']}/48 = {band['solved_fraction']:.4f} (JAX "
            f"{JAX_BAND['trained']}), fresh init {fresh['solved']}/48 = "
            f"{fresh['solved_fraction']:.4f} (JAX untrained "
            f"{JAX_BAND['untrained']}), verified with numpy; "
            f"{band['wall_s']:.2f} s and {fresh['wall_s']:.2f} s")
        require(band["solved"] >= MIN_BAND_SOLVED,
                f"np-d-np solved {band['solved']}/48 of the band < "
                f"{MIN_BAND_SOLVED}")
        gain = band["solved_fraction"] - fresh["solved_fraction"]
        require(gain >= MIN_BAND_GAIN, "the trained np-d-np beats its "
                f"fresh init by {gain:.4f} < {MIN_BAND_GAIN}")

        xres, xlaunches = run_path(lambda: solve_headline(
            insts, seed=0, replicas=2))
        log(f"phase 12 p-d-p compacting_solve(replicas=2): solved "
            f"{xres['solved']}/{len(insts)} = {xres['solved_fraction']:.4f}"
            f" (verified with numpy; phase 3 with one slot an instance "
            f"solved {res['solved']}) in {xres['wall_s']:.2f} s; attempts "
            f"{xres['attempt_solved']}, pdp {xres['pdp_wall_s']} s, walksat "
            f"{xres['ls_wall_s']} s, {xres['compactions']} compactions")
        log(f"launches on the replicas=2 path: {json.dumps(xlaunches)}")
        require(xres["solved_fraction"] >= MIN_SOLVED,
                f"p-d-p with replicas=2 solved {xres['solved_fraction']} < "
                f"{MIN_SOLVED}")

        fres, flaunches = run_path(lambda: replicated_forward(insts, torch))
        log(f"phase 13 p-d-p forward(replication=2) on the shared set "
            f"({REP_ITERATIONS} iterations, {REP_FLIPS} flips, "
            f"check_termination): {fres['solved']}/{len(insts)} "
            f"deduplicated solutions verified with numpy (the solver's "
            f"flags agree) in {fres['wall_s']:.2f} s; "
            f"{flaunches['walksat_walk']} walk launches for "
            f"{fres['blocks']} blocks")
        log(f"launches on the replicated forward: {json.dumps(flaunches)}")
        require(flaunches["walksat_walk"] == fres["blocks"],
                f"the replicated walk launched {flaunches['walksat_walk']} "
                f"times for {fres['blocks']} blocks")
        rcmp = card_vs_cpu(insts, torch)
        log(f"phase 13 replicated card vs cpu: every state column on every "
            f"edge within rtol {FLOAT_TOL['rtol']} / atol "
            f"{FLOAT_TOL['atol']} (max abs err "
            f"{rcmp['state_max_abs_err']:.3g}) and the carry exact after 1 "
            f"iteration; after {REP_CMP_ITERATIONS}, "
            f"{rcmp['var_diff_share']:.4%} of the variables differ "
            f"({rcmp['inactive_vars']} inactive on the CPU), "
            f"{rcmp['flag_diffs']} instance flags differ")

        # seeds 0-2 of p-d-p and reinforce beside earlier counts (seed 0
        # is phases 3 and 6)
        pdp = [res["solved"]] + [solve_headline(insts, seed=k)["solved"]
                                 for k in (1, 2)]
        rnf = [rres["solved"]] + [solve_reinforce(insts, seed=k)["solved"]
                                  for k in (1, 2)]
        log(f"seeds 0-2 (of {len(insts)}, verified with numpy): p-d-p "
            f"{pdp} (before kernel 2's walk: {PRIOR_SOLVED['p-d-p']}); "
            f"reinforce {rnf} (before: {PRIOR_SOLVED['reinforce']})")

        from pdp_solver_tpu_torch.utils.neural import (
            flagship_settings, solve_flagship)
        hres, hlaunches = run_path(lambda: solve_np_nd_np(
            insts, seed=0, compute_dtype=BF16))
        hfrac = hres["solved_fraction"]
        log(f"phase 15 np-nd-np in bf16: solved {hfrac:.4f} "
            f"({hres['solved']}/{len(insts)}, verified with numpy; phase 4 "
            f"in f32 solved {nres['solved']}) in {hres['wall_s']:.2f} s; "
            f"loop {hres['loop_wall_s']} s, walksat {hres['ls_wall_s']} s, "
            f"{hres['chunks']} chunks, {hres['compactions']} compactions, "
            f"progress {hres['progress']}")
        log(f"launches on the np-nd-np bf16 path: {json.dumps(hlaunches)}")
        require(hfrac >= MIN_SOLVED_NEURAL, f"np-nd-np in bf16 solved "
                f"{hfrac} < {MIN_SOLVED_NEURAL}")
        require_bf16_path(hlaunches, "np-nd-np", gather=True)
        small = bf16_small_check(torch)
        log(f"phase 15 tests/test_bf16.py's check on the card (np-nd-np at "
            f"hidden 16, fresh parameters, 3 instances of 10 variables, "
            f"{BF16_SMALL_ITERATIONS} iterations): max |f32 - bf16 "
            f"prediction| {small:.4g} (gate {MAX_BF16_PRED_DIFF})")
        for h, c in neural_bf16_check(torch).items():
            log(f"phase 15 np-nd-np r3 from one state after {h} iterations "
                f"(16 instances, {c['solved']} solved, flags equal card vs "
                f"cpu): max |f32 - bf16 prediction| on the card "
                f"{c['f32_bf16']:.4g}, bf16 card vs cpu {c['card_cpu']:.4g}"
                f" (JAX's own f32 - bf16 {c['jax']}; gate {c['limit']:.4g})")

        p16, p16launches = run_path(lambda: solve_p_nd_np(
            insts, seed=0, compute_dtype=BF16))
        log(f"phase 16 p-nd-np in bf16: solved {p16['solved']}/{len(insts)}"
            f" (verified with numpy; phase 8 in f32 solved {pres['solved']})"
            f" in {p16['wall_s']:.2f} s; loop {p16['loop_wall_s']} s, "
            f"progress {p16['progress']}")
        log(f"launches on the p-nd-np bf16 path: {json.dumps(p16launches)}")
        require(p16["solved"] >= MIN_SOLVED_P_ND_NP, f"p-nd-np in bf16 "
                f"solved {p16['solved']} < {MIN_SOLVED_P_ND_NP}")
        require_bf16_path(p16launches, "p-nd-np", gather=False)

        band16, d16launches = run_path(lambda: np_d_np_3sat_band(
            np_d_np_params(), compute_dtype=BF16))
        log(f"phase 17 np-d-np in bf16 on the medium 3-SAT band: "
            f"{band16['solved']}/48 = {band16['solved_fraction']:.4f} "
            f"(verified with numpy; phase 11 in f32 {band['solved']}/48) in "
            f"{band16['wall_s']:.2f} s")
        log(f"launches on the np-d-np bf16 band: {json.dumps(d16launches)}")
        require(band16["solved"] >= MIN_BAND_SOLVED, f"np-d-np in bf16 "
                f"solved {band16['solved']}/48 of the band < "
                f"{MIN_BAND_SOLVED}")
        require_bf16_path(d16launches, "np-d-np", gather=True)

        gres, glaunches = run_path(lambda: solve_flagship(insts, seed=0))
        fs = flagship_settings()
        log(f"phase 18 the flagship config (PDP-np-nd-np-trained.yaml: "
            f"np-nd-np-full, bf16, {fs['iterations']} iterations, "
            f"{fs['ls']} flips, epsilon {fs['epsilon']}): solved "
            f"{gres['solved']}/{len(insts)} (verified with numpy; recorded "
            f"only) in {gres['wall_s']:.2f} s; loop {gres['loop_wall_s']} s,"
            f" walksat {gres['ls_wall_s']} s, progress {gres['progress']}")
        log(f"launches on the flagship path: {json.dumps(glaunches)}")
        require_bf16_path(glaunches, "the flagship", gather=True)

        grad = train_grad_check(torch, np)
        log(f"phase 19 gradients card vs cpu (np-nd-np r3, flagship "
            f"widths, one {TRAIN_GRAD_DIMS[2]}-edge mixture segment of "
            f"{grad['edges']} real edges, T = 10, dropout 0): loss card "
            f"{grad['loss_card']:.7g} cpu {grad['loss_cpu']:.7g} (rel "
            f"{grad['loss_rel']:.3g}, gate {TRAIN_LOSS_RTOL}); "
            f"{grad['n_grads']} gradients, worst rel "
            f"{grad['grad_rel_max']:.3g} ({grad['grad_rel_worst']}; gate "
            f"{TRAIN_GRAD_REL}); card {grad['card_s']:.2f} s, cpu "
            f"{grad['cpu_s']:.2f} s; launches during backward() "
            f"{json.dumps(grad['backward_counts'])}")

        from pdp_solver_tpu_torch.utils import training
        tres = train_flagship(torch, np)
        sc = tres["step_counts"]
        log(f"phase 20 flagship recipe: {tres['steps']} steps from a fresh "
            f"init at (V, F, E, B) = {training.FIXED_DIMS} (segments "
            f"generated first: {tres['gen_s']:.1f} s, "
            f"{tres['gen_ms_per_segment']:.0f} ms a "
            f"segment), every loss finite (first 10 {tres['loss_first10']:.4f}"
            f", last 10 {tres['loss_last10']:.4f}); held-out energy at "
            f"global_step {TRAIN_EVAL_STEP:g}: {tres['energy_before']:.5f} "
            f"before, {tres['energy_after']:.5f} after; "
            f"{tres['ms_per_step']:.1f} ms a step (first step "
            f"{tres['first_step_s']:.2f} s), {tres['instances_per_s']:.1f} "
            f"instances/s ({tres['instances_per_step']:.1f} a step), peak "
            f"{tres['peak_bytes'] / 2 ** 30:.2f} GiB, global_step "
            f"{tres['global_step']:g}")
        log(f"phase 20 launches in one step: kernel 6 "
            f"{sc['segment_sum_2d']} ({sc['segment_sum_2d[bwd]']} + "
            f"{sc['segment_sum_2d[clause, bwd]']} as backward, var + clause)"
            f", kernel 7 {sc['gather_2d']} ({sc['gather_2d[bwd]']} + "
            f"{sc['gather_2d[clause, bwd]']} as backward), kernel 4 "
            f"{sc['segment_sum_cols']}")
        segs = tres.pop("segments")
        bwd_rows = check_backward_kernels(segs[0][0], torch)
        for name, row in bwd_rows.items():
            row["launches"] = sc[name]
        rows.update(bwd_rows)

        fres = finetune_and_serve(segs, insts, torch, np)
        del segs
        log(f"phase 21 fine-tune from r3 ({FINETUNE_STEPS} steps, fresh "
            f"Adam; loss first 10 {fres['loss_first10']:.4f}, last 10 "
            f"{fres['loss_last10']:.4f}), best and last saved and read back "
            f"bit for bit; served: solved {fres['solved_fraction']:.4f} "
            f"({fres['solved']}/{len(insts)}, verified with numpy; phase 4 "
            f"with r3 {nres['solved']}) in {fres['wall_s']:.2f} s")
        require(fres["solved_fraction"] >= MIN_SOLVED_NEURAL,
                f"the fine-tuned np-nd-np solved {fres['solved_fraction']} "
                f"< {MIN_SOLVED_NEURAL}")

        solved = {"np-nd-np": nres["solved"], "np-nd-np bf16": hres["solved"],
                  "p-nd-np": pres["solved"], "p-nd-np bf16": p16["solved"],
                  "np-d-np": dres["solved"],
                  "np-d-np band": band["solved"]}
        log(f"phases 4, 15, 8, 16, 10, 11 solved {json.dumps(solved)}; "
            f"before the clamp-tie rule {json.dumps(SERVING_SOLVED)}: "
            f"{'unchanged' if solved == SERVING_SOLVED else 'CHANGED'}")
        require(solved == SERVING_SOLVED, "a serving path's solved count "
                "moved from the counts before the clamp-tie rule")

        fam_grad = {}
        for model, ph in zip(FAMILY, (22, 23)):
            g = family_grad_check(model, torch, np)
            fam_grad[model] = g
            tie = ("the decimated problems equal card against cpu after "
                   "every outer step; " if model == "np-d-np"
                   and g["tie"] is None else
                   f"picks differ from step {g['tie']['step']} (|score| gap"
                   f" {g['tie']['gap']:.3g}), gated at T = {g['steps']}; "
                   if g["tie"] else "")
            log(f"phase {ph} gradients card vs cpu ({model} r4, one "
                f"{TRAIN_GRAD_DIMS[2]}-edge segment of the r4 stream, "
                f"{g['edges']} real edges, T = {g['steps']}, dropout 0): "
                f"{tie}loss card {g['loss_card']:.7g} cpu "
                f"{g['loss_cpu']:.7g} (rel {g['loss_rel']:.3g}, gate "
                f"{FAMILY_LOSS_RTOL}); {g['n_grads']} gradients, worst rel "
                f"{g['grad_rel_max']:.3g} ({g['grad_rel_worst']}; gate "
                f"{TRAIN_GRAD_REL}); card {g['card_s']:.2f} s, cpu "
                f"{g['cpu_s']:.2f} s; launches in the forward "
                f"{json.dumps(g['forward_counts'])}, during backward() "
                f"{json.dumps(g['backward_counts'])}")

        import itertools
        t0 = time.time()
        fsegs = list(itertools.islice(training.family_segments(0, FAMILY[0]),
                                      FAMILY_STEPS))
        fgen_s = time.time() - t0
        fam = {}
        for model in FAMILY:
            r = train_family(model, fsegs, torch, np)
            fam[model] = r
            log(f"phase 24 {model} recipe: {r['steps']} steps from a fresh "
                f"init at (V, F, E, B) = {training.FIXED_DIMS} (one set of "
                f"segments for both recipes, generated first: {fgen_s:.1f} "
                f"s), every loss finite (first 10 {r['loss_first10']:.4f}, "
                f"last 10 {r['loss_last10']:.4f}); held-out energy at "
                f"global_step {TRAIN_EVAL_STEP:g}: {r['energy_before']:.5f} "
                f"before, {r['energy_after']:.5f} after; "
                f"{r['ms_per_step']:.1f} ms a step (first step "
                f"{r['first_step_s']:.2f} s), {r['instances_per_s']:.1f} "
                f"instances/s ({r['instances_per_step']:.1f} a step), peak "
                f"{r['peak_bytes'] / 2 ** 30:.2f} GiB; launches in one step "
                f"{json.dumps(r['step_counts'])}")
        mres = train_meta_config(fsegs, torch, np)
        log(f"phase 24 config/Train/p-nd-np-cnf-3-10.yaml (from "
            f"{mres['source']}): {mres['steps']} steps with meta width 1, "
            f"zeros injected, every loss finite (first "
            f"{mres['loss_first']:.4f}, last {mres['loss_last']:.4f})")

        for model in FAMILY:
            r = resume_and_serve(model, fsegs, insts, torch, np)
            if model == "p-nd-np":
                log(f"phase 25 p-nd-np-r4/best resumed (Adam count "
                    f"{r['adam_count']}), {RESUME_STEPS} steps (loss "
                    f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}), best "
                    f"and last saved and read back bit for bit; served: "
                    f"solved {r['solved']}/{len(insts)} (verified with "
                    f"numpy; phase 8 with r4 {pres['solved']}) in "
                    f"{r['wall_s']:.2f} s")
                require(r["solved"] >= MIN_SOLVED_P_ND_NP,
                        f"the resumed p-nd-np solved {r['solved']} < "
                        f"{MIN_SOLVED_P_ND_NP}")
            else:
                log(f"phase 25 np-d-np-r4/last resumed (Adam count "
                    f"{r['adam_count']}), {RESUME_STEPS} steps (loss "
                    f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}), best "
                    f"and last saved and read back bit for bit; served on "
                    f"the band: {r['solved']}/48 (verified with numpy; "
                    f"phase 11 with r4 {band['solved']}/48) in "
                    f"{r['wall_s']:.2f} s")
                require(r["solved"] >= MIN_BAND_SOLVED,
                        f"the resumed np-d-np solved {r['solved']}/48 of "
                        f"the band < {MIN_BAND_SOLVED}")
        del fsegs

        os.chdir(ROOT)   # the configs name their checkpoints and data
        cres = cli_dimacs_serve(insts, np)
        clilaunches = cres["launches"]
        log(f"phase 26 satyr -d on the shared set as 128 DIMACS files "
            f"({CLI_R3_YAML}, {CLI_ITERATIONS} iterations and flips, one "
            f"monolithic forward): solved {cres['solved']}/{len(insts)} "
            f"(every row's unsat_clauses and solved held against numpy; "
            f"phase 4 with compaction {nres['solved']}) in "
            f"{cres['wall_s']:.2f} s; host ms a file: write "
            f"{cres['write_ms_per_file']:.3f}, convert "
            f"{cres['convert_ms_per_file']:.3f} (native parser "
            f"{'built' if cres['native'] else 'absent: Python parse'})")
        log(f"launches on the CLI serve: {json.dumps(clilaunches)}")
        require(cres["solved"] >= MIN_SOLVED_CLI, f"phase 26 solved "
                f"{cres['solved']} < {MIN_SOLVED_CLI}")
        for name in CLI_KERNELS:
            require(clilaunches.get(name, 0) > 0,
                    f"phase 26 never launched {name}")

        pres27 = cli_process_pdp(np)
        prof = pres27["profile"]
        log(f"phase 27 satyr as a process ({CLI_PDP_YAML}, {CLI_SAMPLE}, 80 "
            f"iterations, 100 flips, PDP_PROFILE=1): solved "
            f"{pres27['solved']}/20 (verified with numpy) in "
            f"{pres27['wall_s']:.2f} s with the process's start; profile "
            f"{json.dumps(prof)}; SatTrainer(config).predict in this "
            f"process wrote the same lines")

        import tempfile
        with tempfile.TemporaryDirectory() as gtmp:
            gres = cli_generate(gtmp, np)
            log(f"phase 28 generate ({' '.join(GENERATE_ARGS)}): bands "
                f"{gres['bands']}, labelled 1: {gres['labelled']} of 32 in "
                f"{gres['wall_s']:.2f} s; every DIMACS file converted back "
                f"to its row ({gres['renumbered']} rows with an unused "
                f"variable renumbered by compact); launches "
                f"{json.dumps(gres['totals'])}")
            require(gres["labelled"][0] >= MIN_LABELLED_LOW_BAND,
                    f"phase 28: the lower band has {gres['labelled'][0]} "
                    f"labelled 1 < {MIN_LABELLED_LOW_BAND}")
            require(all(v > 0 for v in gres["totals"].values()),
                    f"phase 28: label_instances skipped a kernel: "
                    f"{gres['totals']}")
            rres = reorder_path(np)
            log(f"phase 28 reorder: {rres['count']} modular instances "
                f"(n 1000, k 3, q 0.8-0.9, c 10-20, alpha 3.0, seed 11) "
                f"reordered in {rres['reorder_ms_per_instance']:.1f} ms an "
                f"instance, solved by p-d-p at the headline settings with "
                f"{rres['flips']} flips in {rres['solve_s']:.2f} s: "
                f"{rres['solved']}/{rres['count']}, each restored "
                f"assignment verified against its original clauses")
            require(rres["solved"] >= MIN_SOLVED_MODULAR, f"phase 28: "
                    f"{rres['solved']} modular instances solved < "
                    f"{MIN_SOLVED_MODULAR}")
            tres29 = cli_train_test(gres, torch, np)
            log(f"phase 29 satyr_train_test -g then -t -l best "
                f"({TRAIN_CLI_YAML} with {json.dumps(TRAIN_CLI_KEYS)}): "
                f"{tres29['steps']} steps, {tres29['ms_per_step']:.1f} ms a "
                f"step (median, synchronised); train run "
                f"{tres29['train_s']:.1f} s, test run "
                f"{tres29['test_s']:.1f} s; losses {tres29['losses']}, "
                f"best and last read back bit for bit; (file, accuracy, "
                f"recall) {json.dumps(tres29['metrics'])}")

        from pdp_solver_tpu_torch.solvers.compact import RETRIES
        torch.cuda.empty_cache()
        multi = {}
        t0 = time.time()
        serve = spawn_ranks("rank_serve", DP_RANKS,
                            {"models": ["p-d-p", "np-nd-np"],
                             "replica": True})
        nccl = spawn_ranks("rank_serve", 1, {"models": ["p-d-p"]},
                           backend="nccl")[0]
        for model, gate, kernels, how in (
                ("p-d-p", MIN_SOLVED, ("k1", "k2", "k3"),
                 "headline solver settings, replication "
                 f"{DP_PDP_REPLICATION}, 1000 iterations and flips"),
                ("np-nd-np", MIN_SOLVED_NEURAL, ("k6", "k7", "k3"),
                 f"r3, {DP_NP_ND_NP_ITERATIONS} iterations, 1000 flips")):
            parts = [r[model] for r in serve]
            frac = parts[0]["frac"]
            solved = sum(x["solved"] for x in parts)
            require(all(x["frac"] == frac for x in parts)
                    and solved == round(frac * len(insts)),
                    f"phase 30 {model}: the ranks' fractions "
                    f"{[x['frac'] for x in parts]}, numpy {solved}")
            for r, x in enumerate(parts):
                require(x["flags_equal"] and x["max_diff"] <= (
                    0.0 if model == "p-d-p" else DP_PRED_ATOL),
                    f"phase 30 {model}: rank {r}'s predictions differ from "
                    f"the serial solve's by {x['max_diff']} (flags equal: "
                    f"{x['flags_equal']})")
            kc = sum_kernels([x["kernels"] for x in parts])
            require_kernels(kc, kernels, f"phase 30 {model}")
            multi[f"phase 30 {model}"] = sum_counts(
                [x["launches"] for x in parts])
            require(frac >= gate, f"phase 30 {model}: solved {frac} < {gate}")
            log(f"phase 30 data-parallel {model} ({how}) on {DP_RANKS} gloo "
                f"ranks sharing the card, {len(insts) // DP_RANKS} instances "
                f"a rank:"
                f" solved {frac:.4f} ({solved}/{len(insts)}, verified with "
                f"numpy) in {max(x['wall_s'] for x in parts):.2f} s; each "
                f"rank's predictions against its serial forward from the "
                f"same state: max |diff| "
                f"{max(x['max_diff'] for x in parts):.3g}, flags equal; "
                f"kernels {json.dumps(kc)}; collectives "
                f"{json.dumps([x['collectives'] for x in parts])}")
        rep = [r["replica"] for r in serve]
        kc = sum_kernels([x["kernels"] for x in rep])
        require_kernels(kc, ("k1", "k2", "k3"), "phase 30 replica solve")
        multi["phase 30 replica"] = sum_counts([x["launches"] for x in rep])
        require(rep[0]["frac"] >= MIN_SOLVED_ONE_ATTEMPT
                and rep[0]["solved"] == round(rep[0]["frac"] * len(insts)),
                f"phase 30 replica solve: {rep[0]['frac']}, numpy "
                f"{rep[0]['solved']}")
        log(f"phase 30 replica-parallel p-d-p on a (1, {DP_RANKS}) mesh "
            f"(every rank the whole set from its own init, headline solver "
            f"settings, one attempt): solved {rep[0]['frac']:.4f} "
            f"({rep[0]['solved']}/{len(insts)}, verified with numpy) in "
            f"{max(x['wall_s'] for x in rep):.2f} s; instances taken from "
            f"each replica {rep[0]['chosen']}; kernels {json.dumps(kc)}")
        nd = nccl["p-d-p"]
        require_kernels(nd["kernels"], ("k1", "k2", "k3"), "phase 30 NCCL")
        multi["phase 30 p-d-p, 1 NCCL rank"] = sum_counts([nd["launches"]])
        require(nd["frac"] >= MIN_SOLVED and nd["flags_equal"]
                and nd["max_diff"] == 0.0, f"phase 30 NCCL rank: {nd}")
        sat_s = satyr_torchrun(pres27["lines"])
        retries = [r["retries"] for r in serve] + [nccl["retries"]]
        log(f"phase 30 p-d-p on 1 NCCL rank (128 instances): solved "
            f"{nd['frac']:.4f} ({nd['solved']}/{len(insts)}, verified with "
            f"numpy; equal to its serial forward) in {nd['wall_s']:.2f} s; "
            f"satyr under torchrun --nproc-per-node {DP_RANKS} wrote phase "
            f"27's {len(pres27['lines'])} lines in {sat_s:.2f} s; retries "
            f"{retries}; phase 30 in {time.time() - t0:.1f} s")
        require(not any(retries), f"phase 30: retries {retries}")

        t0 = time.time()
        tr31 = spawn_ranks("rank_train", DP_RANKS, {})
        kc = sum_kernels([x["kernels"] for x in tr31])
        require_kernels(kc, ("k6", "k7"), "phase 31 train step")
        multi["phase 31 train step"] = sum_counts(
            [x["launches"] for x in tr31])
        require(tr31[0]["loss"] == tr31[1]["loss"]
                and np.isfinite(tr31[0]["loss"]), "phase 31: the ranks' "
                f"mean losses {[x['loss'] for x in tr31]}")
        require(tr31[0]["max_param_diff"] <= TRAIN_DP_ATOL, "phase 31: the "
                f"parameters differ from a serial step on the mean gradient "
                f"by {tr31[0]['max_param_diff']}")
        ms31 = max(x["ms_per_step"] for x in tr31)
        log(f"phase 31 flagship-recipe train step on {DP_RANKS} gloo ranks "
            f"(segments of {training.FIXED_DIMS}, hidden 150, T = 10): "
            f"parameters within {tr31[0]['max_param_diff']:.3g} of a serial "
            f"step on the mean of the two segments' gradients (gate "
            f"{TRAIN_DP_ATOL}); mean loss {tr31[0]['loss']:.5f}; "
            f"{ms31:.1f} ms a step (median of {TRAIN_DP_TIMED}, both ranks "
            f"on the card); each rank's kernels span "
            f"{[round(x['busy_ms'], 1) for x in tr31]} ms of it (idle share"
            f" by rank {[round(1.0 - x['busy_ms'] / ms31, 3) for x in tr31]};"
            f" the two processes time-slice the card, so each span holds "
            f"the other's slices); first step "
            f"{max(x['first_s'] for x in tr31):.2f} s; kernels "
            f"{json.dumps(kc)}; collectives of the first step "
            f"{json.dumps(tr31[0]['collectives'])}; phase 31 in "
            f"{time.time() - t0:.1f} s")

        t0 = time.time()
        edge = spawn_ranks("rank_edge", DP_RANKS, {})
        score1, ms1, kc1, _, _ = edge_sp_run(np, 1, 0)
        for r, x in enumerate(edge):
            require(np.allclose(x["score"], score1, **EDGE_SP_TOL),
                    f"phase 32: rank {r}'s marginals differ from 1 rank's "
                    f"by {np.abs(x['score'] - score1).max()}")
            require(np.array_equal(x["sol"], edge[0]["sol"]),
                    "phase 32: the ranks' solutions differ")
        kc = sum_kernels([x["sp_kernels"] for x in edge])
        require_kernels(kc, ("k4",), "phase 32 edge-sharded SP")
        kcs = sum_kernels([x["solve_kernels"] for x in edge])
        require_kernels(kcs, ("k4",), "phase 32 edge-sharded solve")
        multi["phase 32 edge-sharded SP"] = sum_counts(
            [x["sp_launches"] for x in edge])
        multi["phase 32 edge-sharded solve"] = sum_counts(
            [x["solve_launches"] for x in edge])
        from pdp_solver_tpu_torch.solvers.compact import instance_slices
        from pdp_solver_tpu_torch.utils.headline import verify_solution
        e16 = insts[:EDGE_SOLVE_COUNT]
        one = edge_solve_run(1, 0)

        def edge_checked(res, what):
            ok = [verify_solution(i, res["sol"][v:v + n]) for i, (
                v, _, _, n, _, _) in zip(e16, instance_slices(e16))]
            flags = [bool(f > 0) for f in res["solved"][:len(e16)]]
            require(all(o for o, f in zip(ok, flags) if f), f"phase 32: a "
                    f"solution the edge-sharded solver reports on {what} "
                    "fails numpy")
            require(sum(flags) >= MIN_SOLVED_EDGE, f"phase 32: the "
                    f"edge-sharded solve on {what} solved {sum(flags)} < "
                    f"{MIN_SOLVED_EDGE}")
            return ok, flags
        ok, flags = edge_checked(edge[0], f"{DP_RANKS} ranks")
        _, flags1 = edge_checked(one, "1 rank")
        agree = sum(a == b for a, b in zip(flags, flags1))
        require(np.array_equal(one["sol"], edge[0]["sol"])
                and flags == flags1, f"phase 32: {DP_RANKS} ranks and 1 "
                f"rank differ: flags equal on {agree}/{len(e16)}")
        log(f"phase 32 edge-sharded SP, one 4-SAT instance (n {EDGE_SP_N}, "
            f"alpha {EDGE_SP_ALPHA:g}, {int(EDGE_SP_N * EDGE_SP_ALPHA) * 4} "
            f"edges), {EDGE_SP_SWEEPS} sweeps: {DP_RANKS} ranks against 1 "
            f"max |diff| {max(np.abs(x['score'] - score1).max() for x in edge):.3g}"
            f" (rtol {EDGE_SP_TOL['rtol']}, atol {EDGE_SP_TOL['atol']}); ms "
            f"a sweep {max(x['ms_per_sweep'] for x in edge):.2f} on "
            f"{DP_RANKS} ranks, {ms1:.2f} on 1; kernel 4 launches "
            f"{kc['k4']} ({kc1['k4']} on 1 rank); collectives "
            f"{json.dumps(edge[0]['sp_collectives'])}")
        log(f"phase 32 edge-sharded p-d-p solve of the shared set's first "
            f"{EDGE_SOLVE_COUNT} instances on {DP_RANKS} ranks "
            f"({json.dumps(EDGE_SOLVE)}): solved {sum(flags)}/"
            f"{len(e16)} (gate {MIN_SOLVED_EDGE}; every reported solution "
            f"verified with numpy; {sum(ok)} verify), "
            f"{edge[0]['iterations']} iterations in "
            f"{max(x['solve_s'] for x in edge):.2f} s; on 1 rank from the "
            f"same generator state solved {sum(flags1)}/{len(e16)} in "
            f"{one['solve_s']:.2f} s, the same solutions and flags; kernels "
            f"{json.dumps(kcs)}; collectives "
            f"{json.dumps(edge[0]['solve_collectives'])}; phase 32 in "
            f"{time.time() - t0:.1f} s")

        t0 = time.time()
        meshr = spawn_ranks("rank_mesh", DP_RANKS, {})
        require(meshr[0]["solved"] == meshr[1]["solved"],
                "phase 33: the ranks' solved lists differ")
        ok = [verify_solution(i, s) for i, s in zip(insts, meshr[0]["sols"])]
        require(ok == [bool(x) for x in meshr[0]["solved"]], "phase 33: a "
                "solution parallel_compacting_solve reports disagrees with "
                "numpy")
        kc = sum_kernels([x["kernels"] for x in meshr])
        require_kernels(kc, ("k1", "k2", "k3"), "phase 33 compacting mesh")
        multi["phase 33 compacting mesh"] = sum_counts(
            [x["launches"] for x in meshr])
        require(sum(ok) >= MIN_SOLVED_ONE_ATTEMPT * len(insts), f"phase 33: "
                f"parallel_compacting_solve solved {sum(ok)}")
        require(not any(x["retries"] for x in meshr), "phase 33: retries")
        st = meshr[0]["stats"]
        res33 = resilient_check(torch, np)
        log(f"phase 33 parallel_compacting_solve on {DP_RANKS} ranks (the "
            f"shared set, headline solver settings, one attempt): solved "
            f"{sum(ok)}/{len(insts)} (verified with numpy) in "
            f"{max(x['wall_s'] for x in meshr):.2f} s; {st['chunks']} "
            f"chunks, compactions "
            f"{[(c['iter'], c['per_shard'], c['edges']) for c in st['compactions']]}"
            f", walksat {st['ls_wall_s']} s; kernels {json.dumps(kc)}; "
            f"collectives {json.dumps(meshr[0]['collectives'])}")
        log(f"phase 33 resilient_solve of the shared set "
            f"({RESILIENT_ITERATIONS} iterations in chunks of "
            f"{RESILIENT_CHUNK}): {res33['solved']}/{len(insts)} solved in "
            f"{res33['wall_s']:.2f} s, 0 retries; an injected fault at chunk"
            f" 2 recovered (1 retry) to the same prediction; a process "
            f"killed after {RESILIENT_STOP} chunks (exit {res33['codes'][0]},"
            f" checkpoint at {res33['done']} iterations) and a new process "
            f"resumed to the same prediction bit for bit (exit "
            f"{res33['codes'][1]}, {res33['resumed_retries']} retries); "
            f"phase 33 in {time.time() - t0:.1f} s")
        require(RETRIES["count"] == 1, f"{RETRIES['count']} retries in this "
                "process, 1 injected")

        # the launches of one training step of each r4 recipe (phase 24)
        for name in ("smax", "sround", "segment_sum_cols", "segment_sum_2d",
                     "gather_2d", "segment_sum_2d[bwd]",
                     "segment_sum_2d[clause, bwd]", "gather_2d[bwd]",
                     "gather_2d[clause, bwd]"):
            rows[name]["training_step_launches"] = {
                m: fam[m]["step_counts"].get(name, 0) for m in FAMILY}

        # each row carries the launches of the path it serves
        serves = {"segment_sum_2d": nlaunches, "gather_2d": nlaunches,
                  # the split passes the folds replace: the unfolded loop
                  **{n: ulaunches for n in SPLIT_PDP_KERNELS},
                  **fold_paths,
                  "segment_sum_2d[bf16]": hlaunches,
                  "gather_2d[bf16]": hlaunches,
                  "scorer": rlaunches, "segment_sum_cols": rlaunches,
                  "segment_sum_cols[ragged]": rlaunches,
                  "sorted_segment_sum": rlaunches,
                  "sp_full_sweep": slaunches, "sp_chain_login": plaunches,
                  "sp_full_sweep[login]": qlaunches,
                  "verify_and_masks": qlaunches, "smax": dlaunches,
                  "walksat_walk[replicas=2]": flaunches}
        path_rows = []
        for name, row in rows.items():
            path = serves.get(name, launches)
            # rows 5 and 8 run the CUDA kernel of row 4; both WalkSAT
            # rows are walksat_walk's launches
            key = ("segment_sum_cols" if name.startswith(
                ("segment_sum_cols", "sorted_segment_sum"))
                else "walksat_walk" if name.startswith("walksat")
                else name)
            n = row["launches"] if "launches" in row else path.get(key, 0)
            require(n > 0, f"{row['name']} never launched on its path")
            path_rows.append(dict(
                row, launches=n, cli_serve_launches=clilaunches.get(key, 0),
                multi_card_launches={p: c[key] for p, c in multi.items()
                                     if c.get(key)}))
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1

    print(json.dumps({"kernels": path_rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
