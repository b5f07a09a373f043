"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--ncycles N] [--niterations N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. card and build: the card's name and power limit; the CUDA kernels
   ``symbolicregression_jl_tpu_torch/csrc/postfix_eval.cu`` (scoring),
   ``csrc/postfix_grad.cu`` (constant optimisation) and
   ``csrc/instr_eval.cu`` (instruction programs) built with nvcc for each
   working dtype (float32, the bfloat16 and float16 storage builds and
   the float64 build, ``-DSR_STORAGE``), twelve processes started
   together, each with its nvcc seconds and ptxas's register /
   shared-memory / spill lines; with them the fourteen libraries of the
   headers generated for the user operators and the loss callable of
   phases 3f, 5g and 8 (``-DSR_USER_OPS``; three of them float64);
1b. the threefry kernel (``csrc/threefry.cu``, every split and draw of the
   search: threefry2x32 in JAX's partitionable mode) against its plain
   version (``utils/rng.py``, run on the host) on 16,384 keys x 72 draws
   (1,179,648 pairs, more than one pass of the kernel's grid) in every
   mode and epilogue: split, fold_in, bits at 8, 16, 32 and 64, uniform /
   normal / gumbel in float32, bfloat16, float16 and float64, randint with
   a device bound, strided keys; bit-equal, but float64 normal and gumbel,
   whose log is CUDA's against the C library's (within 1e-11 relative);
   then jax 0.9's own draws, frozen in ``JAX_LITERALS``; then each mode at
   the main path's shapes, bit-equal to its plain version there and timed
   beside it (host clock) and its bound; then every draw plan of the main
   path (``propose``, ``mutate`` with the random-tree loop,
   ``crossover``, init's ``random_tree_draws``, 5h(c)'s ``minibatch``) at
   its shape, one launch of the plan kernel bit-equal to its plain
   version and to the per-call kernels' chain, timed beside that chain,
   the plain version and its bound; and the first four again in float64
   (phase 5h(a)'s float64 search; the plan kernel's float64
   instantiation), bit-equal to the per-call chain and to the plain
   version but their normal and gumbel draws, within 1e-11 of it relative
   to max(|value|, 1) (CUDA's log against the C library's);
2. scoring kernels vs plain PyTorch versions on the card at the main
   path's shapes (Feynman-I.6.2a, 2048 rows; 5,376 trees = one cycle's
   children at 64 islands x 1000, 64,000 trees = one rescore), poisoning
   trees, bare leaves and a unary chain included: the postfix kernel in
   both modes (the value mode bit-equal to its plain version; two
   launches of the fused mode give the same bits); the constant-fold
   kernel (``simplify_tree`` in one launch) on those trees and on copies
   whose variables are mostly constants (many folds, some to a value
   that is not finite): every field and ``changed`` bit-equal to the
   plain fold and over two launches, and its slot-values output bit-equal
   to its plain version; invalid programs left as they were; and the
   instruction-program kernels, whose values must be bit-equal to the
   postfix value mode's;
3. constant-optimisation kernel vs plain version at the main path's
   shapes: the gradient variant at 26,880 instances (one BFGS step at 64
   islands x 3 starts x 140 members; its loss, gradients and flags
   bit-equal to the plain mirror of its sweeps and sums, and over two
   launches; its loss bit-equal to the loss-only variant's for the same
   constants, in both of that kernel's layouts), the loss-only variant at
   215,040 (its line search, 8 candidates each; two launches give the
   same bits); unweighted and weighted with zero-weight rows, poisoning
   trees included; both variants at max_len 128 on programs of up to 109
   slots; then every kernel on random trees over all 44 registry
   operators (the fold's structure exact, its constants within rtol 1e-5:
   torch's and CUDA's bodies of some operators differ in an ulp), the
   hand-written digamma against torch.digamma, a short
   search over the operators the earlier slices did not carry, and a
   short search at maxsize 110 (max_len 112) with the default BFGS;
3c. every kernel at max_len 512, 1,024 and 2,048 (the narrow routes,
   their stacks or results in shared or global memory; the fold's arenas
   in shared memory at 512, in global memory above) on 2,048 rows, random
   and deep programs, poisoning and invalid programs: B1, the slot values
   and the fold bit-equal to their plain versions, B2 within rtol
   1e-4, B3 bit-equal to its plain mirror with its loss bit-equal to B4's,
   B5 / B6 bit-equal to B1 (B6 where its packed word takes the width), two
   launches the same bits; then a short search at maxsize 509 (max_len
   512) with the default BFGS;
3d. every elementwise loss of the registry (csrc/losses.cuh) in B2 at
   5,376 and 64,000 trees, B3 at 26,880 instances and B4 at 215,040 x
   2,048 rows: two launches the same bits, B3's loss bit-equal to B4's,
   against the plain mirrors (B2's sums under its launch plan, B3 on the
   first 4,096 instances) bit for bit for the losses without a
   transcendental function, within rtol 1e-5 (and the row-sum yardstick
   for gradients) for the rest;
3e. the bfloat16 and float16 builds: B1, the fold, B5 and B6 at
   5,376 and 64,000 trees, B3 at 26,880 instances and B4 at 26,880 and
   215,040, x 2,048 rows (unweighted and with zero-weight rows), then every
   kernel at max_len 512 and 1,024 (the narrow routes): bit-equal to the
   plain versions (which round every value as the kernels do), B5/B6 to
   B1, B3's loss to B4's, two launches the same bits, programs that
   overflow only at the storage rounding and invalid programs poisoned;
3g. the float64 builds, the same checks at the same shapes (5,376 /
   64,000 trees, B3 at 26,880 instances, B4 at 26,880 and 215,040, x
   2,048 rows, then max_len 512 and 1,024): every one bit-equal to its
   plain version (which computes in float64), B5 / B6 to B1, B3's loss to
   B4's, two launches the same bits, invalid programs poisoned; then the
   gradient kernel's cotangent-seeded mode at float32 and float64 (the
   VJP of B1's value with respect to the constants for a seed per
   instance and row, a custom objective's gradient): bit-equal to its
   plain mirror on 4,096 instances and within the row-sum yardstick of
   the lockstep interpreter's autograd VJP on 1,024;
3f. user operators (the reference's ``op2c`` / ``op3c``) and a loss
   callable in every kernel: 4,096 random trees over ``+ * op2c | op3c
   cos`` x 2,048 rows at float32, bfloat16 and float64, B1, the slot
   values, the fold, B5, B6
   against their plain versions (B5 / B6 bit-equal to B1), B2, B3 and B4
   under ``(p - t) ** 2`` (B3 against its mirror, B4's loss B3's in every
   bit), two launches the same bits; the bit-equal share of each, the rest
   at phase 3's tolerances; then each user instantiation timed beside the
   registry's full instantiation on trees of the same shape (``+ * atan2
   | sin cos``, B2-B4 under ``LPDistLoss(2)``), with its bound;
4. timing of every kernel alone (its launches queued behind a spin on the
   card, CUDA events), beside its plain version and its bound (bytes over
   3.35 TB/s, f32 operations over 67 TFLOP/s); the launch layout of the
   scoring, gradient, loss-only and instruction-program kernels (work
   items per tree, rows or candidates per lane, warps per block, resident
   blocks per SM) and their ptxas lines; the instruction-program wrappers'
   host milliseconds per call; B2, B3 and B4 under L1, Huber and LogCosh
   beside L2, and the fused scoring route against the value route (B1,
   the loss in PyTorch, ``aggregate_loss``) at 5,376 and 64,000 trees;
   every bfloat16, float16 and float64 build beside float32's (bound with
   X, constants and outputs at 2 bytes, at 8 and the operations over the
   FP64 peak, half the FP32 peak, for float64), the value route of a
   scoring call at those dtypes, and the cotangent-seeded mode at float32
   and float64 beside B3 under L2;
5. the main path: ``equation_search`` at 64 islands x 1000, maxsize 20,
   ``+ - * /`` with ``cos exp``, L2 loss, default constant optimisation
   (BFGS), then ``predict``; every cycle is a replay of one captured CUDA
   graph (``models/cycle_graph.py``: one capture, niterations x ncycles
   replays, its pool's device memory printed beside the peak); the launch
   counts (a replay adds what its capture counted; the threefry kernel's
   by mode and by plan among them, every per-call mode but ``bits`` and
   every plan of the cycle launched, float32 epilogues only; the fold
   kernel once a cycle and once a rescore) are
   zeroed just before and read just after, and each iteration's
   optimisation pass is timed; then
   the same search with ``kernel_program="instr"`` and ``"instr_packed"``
   (one iteration of 275 cycles each, same seed: their halls of fame must
   be bit-equal), the counts zeroed before and read after each; then a short
   search whose every batch must hold valid programs only; then the
   search at the same widths under ``loss="HuberLoss"`` (1 iteration of
   100 cycles, default BFGS): every scoring call through the fused mode's
   any-loss instantiation, B3 and B4 under Huber, no value-mode call;
5e. the search at the same widths at ``precision="bfloat16"``, then
   ``"float16"`` (1 iteration of 100 cycles; then 20 cycles on each
   instruction program): every launch of that dtype's builds (the value
   mode, B5 or B6 for every scoring call, the slot mode, B3 and B4), no
   fused-mode launch and no float32 build launched;
5f. the solo front door at the same widths, 1 iteration of 100 cycles
   per output: ``y`` of two outputs (Feynman I.6.2a and ``2 cos(theta) -
   1``) on one captured cycle (one capture, replays for both), output 1
   bit-equal to the solo search at seed 7919; ``data_policy="mask"`` with
   5 % of y's rows NaN (a second capture for the weighted key, every
   scoring call on B1's value mode, BFGS on weighted B3 / B4, no plain
   version reached); the CSV checkpoint (its round trip exact on equations
   and complexities) and a warm start from it; a resume of both outputs
   from ``return_state`` (the saved state unchanged);
5g. user operators and the loss callable at the same widths: 1 iteration
   of 100 cycles over ``+ * op2c | op3c cos`` under ``(p - t) ** 2`` with
   BFGS, Nelder-Mead and Newton (every plain version a raising stub): 102
   fused launches of B2's user instantiation, no value mode, no registry
   library, B3 / B4's user instantiation 9 / 8, 0 / 25 and 8 / 8 times,
   each optimisation pass timed; then 20 cycles weighted, on ``"instr"``
   and on ``"instr_packed"`` (B1's, B5's and B6's user instantiations);
5h. the three options of the float64 slice at the same widths,
   every plain version a raising stub and each run's counts zeroed just
   before and read just after: ``precision="float64"`` (1 iteration of
   100 cycles, then 20 on each instruction program; every launch a
   float64 build), a custom objective (``loss_function``, the mean
   squared error through ``eval_tree``, 1 iteration of 100 cycles: every
   scoring call one B1 launch, no B2, BFGS's gradient on B3's cotangent
   mode; then 20 cycles at float64), and ``independent_island_batches``
   (batch 50, 100 cycles: one capture, one B2 launch per replay over
   the 64 islands' minibatches, the per-set form);
6. the cycle alone at the same widths: 10 eager cycles with
   ``simplify_tree`` on the fold kernel bit-equal to 10 on the plain fold
   from one state, milliseconds per eager cycle through each
   (interleaved, twice each), and a profile of 20 eager cycles
   without init, simplify or rescore (device kernels per cycle, idle
   share, host synchronisations per cycle by issuing operator: there must
   be none, and no copy from or to host memory); then the captured cycle
   against the eager one: bit-equal states (the islands' threefry keys
   included) and launch counts after 20 cycles from one state, the
   threefry launches per replayed cycle by plan (the propose, mutate and
   crossover plans once each, no per-call launch; at most 24) and the
   fold kernel's (one), milliseconds
   per cycle A B B A
   over 50 cycles each, and a profile of 20 replayed cycles (device
   kernels per cycle, idle share), with replays, captures, capture seconds
   and the graph pool's memory; the scoring wrapper alone, and the
   instruction programs' scoring call, must make no host wait;
7. the optimisation pass alone on that 64 x 1000 state: milliseconds per
   pass, and a profile of one pass (device kernels, the kernels' share);
8. recovery on the card: ``x0*x0 - x1*x2`` without constant optimisation,
   ``2*cos(x4) + x1^2 - 2`` with it, under L2 and under ``L1DistLoss``;
   the reference's ``test_multi_output`` on that fixture (``x0*x0 -
   x1*x2`` and ``2*cos(x4) + x1^2 - 2`` as two outputs, each to its
   threshold), and ``to_callable`` on B1 bit-equal to ``predict`` and to
   B1's plain version;
   the reference's precision sweep (``tests/test_precision.py``
   ``_tiny_search``) at float32 over seeds 0-15, its count of recovered
   seeds beside the reference's (at least the reference's less 2), then
   bfloat16 and float16 at every seed float32 recovers; the reference's
   ``test_search_with_custom_operator``, ``test_custom_elementwise_loss``
   and ``test_nelder_mead_search`` (and Newton on its target), each to a
   loss below 1e-2; and ``test_custom_loss_function_steers_search`` (loss
   below 1e-2, its objective through ``eval_tree``),
   ``test_independent_island_batches`` (finite) and the search of
   ``test_float64_in_subprocess`` (in this process, at seeds 0-15: loss
   below 1e-8 at its seed 0, and recovered at no fewer seeds than the
   reference's float32 sweep, 9 of 16; a float64 search draws the
   reference's x64 stream, so its seeds are not float32's);
9. tenant-batched serving (``serving/``): (a) B1, B2, B3 and B4 in the
   per-set form (one launch over 64 datasets of (5, 256), the trees set-
   major) at the serving search's trees per set (30 children a cycle, 495
   members a rescore, 225 BFGS instances, 8 line-search candidates each;
   30 and 225 are not multiples of the warps per block), float32 and
   bfloat16, unweighted and weighted: each set bit-equal to the same
   kernel launched on that set alone and to its plain version (B2 to its
   mirror at phase 3d's L2 tolerance, with its bit-equal share), each
   per-set launch timed beside the 64 single-set launches, its plain
   version and its bound; (b) ``batched_equation_search`` of 64 tenants
   (y_t = a_t cos(x3) + x0^2 - b_t from the seed) at the reference's
   default widths (15 islands x 33, maxsize 20, 550 cycles, BFGS), every
   plain version a raising stub: tenants 0 and 63 after one iteration
   bit-equal to their solo ``equation_search`` (every island field, the
   hall of fame, the key, the frontier), then 2 iterations with the
   counts zeroed before and read after (one B2 launch per replayed cycle
   for all 64 tenants, 9 B3 and 8 B4 per iteration), s per iteration
   beside the solo search's, peak memory, and the batch's and one solo
   search's captured cycle (ms per replay A B B A, device kernels and
   host waits per replay: none); (c) 4 tenants x 2 iterations x 50
   cycles, weighted, with ``batching=True``, with
   ``independent_island_batches`` and at bfloat16, each tenant bit-equal
   to its solo search; (d) the ``JobServer``: six jobs of 97-300 rows and
   2 or 5 features (two buckets) at ``max_tenants=4``, 20 cycles, drained,
   each result's frontier bit-equal to ``batched_equation_search`` of its
   bucket's padded data.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""

import argparse
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the H100 SXM's FP64 peak outside the tensor cores: half its FP32 peak
F64_OPS_PER_S = F32_OPS_PER_S / 2
ROWS = 2048
T_CYCLE = 64 * 84  # children per cycle: 64 islands x B=84
T_RESCORE = 64 * 1000
T_OPT = 64 * 3 * 140  # BFGS instances: islands x starts x round(1000 * 0.14)
LS_STEPS = 8  # line-search candidates per instance
INSTR_CYCLES = 275  # cycles of phase 5's one iteration on each instr program

# jax 0.9's draws for PRNGKey(20261018) on the CPU, frozen (this script
# imports no JAX; tests/test_torch_prng.py checks them against JAX): the
# threefry kernel must give these bits on the card
JAX_LITERALS = {
    "seed": 20261018,
    "key": [0, 20261018],
    "split4": [[1965894874, 4140079318], [1151226145, 1975769135],
               [3142536735, 3559190347], [3438793069, 2923984588]],
    "fold_in": [2471504572, 78645587],
    "bits32": [2213131276, 828213518, 1869324628, 1656727457, 2089056151,
               1365478434, 3665629991, 3544550453],
    "uniform_bits": [1057221044, 1044739616, 1054791488, 1053130572,
                     1056508140, 1050855192, 1062894866, 1062421900],
    "normal_bits": [1025308740, 3210613918, 3190225133, 3197416851,
                    3171660535, 3203559347, 1065784697, 1064274036],
    "gumbel_bits": [1053975802, 3204391372, 1044152372, 1028056861,
                    1051176072, 3188424302, 1072419404, 1070806567],
    "randint": [100, 202, 457, 565, 662, 458, 255, 602],
    "choice": [18, 4, 32, 20, 3, 21],
}


def log(*a):
    print(*a, flush=True)


def feynman_data(seed=0):
    """Feynman-I.6.2a: y = exp(-theta^2/2)/sqrt(2 pi), theta ~ U(1, 3)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(1.0, 3.0, ROWS).astype(np.float32)
    y = (np.exp(-(theta ** 2) / 2.0) / np.sqrt(2 * np.pi)).astype(np.float32)
    return theta[None, :], y


def host_cpu():
    """The host's CPU model and the cores this process may use."""
    name = platform.processor() or "unknown CPU"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{name}, {len(os.sched_getaffinity(0))} cores usable"


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn over reps calls (CUDA events): the
    host's work and the card's, whichever is the longer."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps):
    """Device milliseconds per call of fn, which must not wait for the
    card: the calls are queued behind a spin on the card and timed by CUDA
    events around them, so the host's cost of launching does not show. The
    spin doubles until the card is still in it when the last call is
    queued."""
    fn()
    torch.cuda.synchronize()
    spin = 1 << 23  # clock cycles, ~4 ms
    while True:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        queued = not e0.query()
        torch.cuda.synchronize()
        if queued:
            return e0.elapsed_time(e1) / reps
        spin *= 2
        # a call that waits for the card, or more launches than the
        # card's queue holds behind the spin, never ends queued
        assert spin < 1 << 34, "device_ms: the calls do not stay queued"


def synthetic_generator(seed, dev):
    """A torch generator for synthetic kernel inputs (tree sizes, data,
    constant perturbations); the search itself draws from threefry keys."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def random_trees(gen, sizes, nfeatures, operators, max_len, dev):
    """Random trees of ``sizes`` grown by the port's
    ``gen_random_tree_fixed_size``, one threefry key per tree drawn with
    ``gen``."""
    from symbolicregression_jl_tpu_torch.models.mutate_device import (
        gen_random_tree_fixed_size,
    )

    keys = torch.randint(0, 2 ** 32, (sizes.shape[0], 2), generator=gen,
                         device=dev)
    return gen_random_tree_fixed_size(keys, sizes, nfeatures, operators,
                                      max_len)


# constants that fold to an overflow, NaN, infinities or signed zeros, or
# round differently at each working dtype
FOLD_SPECIAL = (0.0, -0.0, 1e30, float("inf"), float("nan"), 300.0, 70000.0,
                0.1)


def constant_heavy(trees, gen, share=0.7):
    """``trees`` with about ``share`` of their variables turned into
    constants (normal x 2, a tenth of them ``FOLD_SPECIAL``), so that many
    subtrees fold and some fold to a value that is not finite; the
    constants in ``trees``' dtype."""
    from symbolicregression_jl_tpu_torch.models.trees import CONST, VAR

    shape, dev = trees.kind.shape, trees.kind.device
    flip = (trees.kind == VAR) & (
        torch.rand(shape, generator=gen, device=dev) < share)
    special = torch.tensor(FOLD_SPECIAL, device=dev)[torch.randint(
        0, len(FOLD_SPECIAL), shape, generator=gen, device=dev)]
    c = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.1,
                    special, torch.randn(shape, generator=gen, device=dev) * 2)
    return trees._replace(kind=torch.where(flip, CONST, trees.kind),
                          feat=torch.where(flip, 0, trees.feat),
                          cval=torch.where(flip, c.to(trees.cval.dtype),
                                           trees.cval))


def float_bits(t):
    """The bit patterns of 2-, 4- or 8-byte floats."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def fold_mismatch(got, ref):
    """{field: count} of the ``simplify_tree`` fields (and ``changed``)
    whose bits differ between two (trees, changed) results."""
    (gt, gc), (rt, rc) = got, ref
    out = {}
    for f in gt._fields:
        a, b = getattr(gt, f), getattr(rt, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            a, b = float_bits(a), float_bits(b)
        n = int((a != b).sum())
        if n:
            out[f] = n
    if int((gc != rc).sum()):
        out["changed"] = int((gc != rc).sum())
    return out


def fold_bytes(trees, changed):
    """The bytes a fold of ``trees`` must move, given which trees it
    changes (``changed``, the plain fold's): each length read once; the
    live slots of a changed tree read once (its tail is written as PAD
    unread) and every slot of an unchanged tree read once (it is written
    back as it was), as int64 kind, op and feat and the constants; every
    field and ``changed`` written once."""
    T, L = trees.kind.shape
    slot = 24 + trees.cval.element_size()
    ch = changed.to(torch.bool)
    read_slots = int(trees.length[ch].sum()) + L * int((~ch).sum())
    return (read_slots * slot + T * 8) + (T * L * slot + T * 8 + T)


def plain_fold(trees, operators, chunk=8192):
    """``simplify_tree_plain`` in chunks of trees (its (T, L, L) masks)."""
    from symbolicregression_jl_tpu_torch.models.mutate_device import (
        simplify_tree_plain,
    )

    parts = [simplify_tree_plain(trees[i:i + chunk], operators)
             for i in range(0, trees.length.shape[0], chunk)]
    return (type(trees)(*(torch.cat(z) for z in zip(*(q[0] for q in parts)))),
            torch.cat([q[1] for q in parts]))


# the main path's threefry calls at 64 islands x 1000 (B = 84 tournaments,
# 10 attempts, max_len 24): (keys, draws per key) of each mode's timed call
RNG_SHAPES = {"split": (64 * 84 * 10, 2), "bits": (64 * 84, 1000),
              "uniform": (64 * 84 * 10, 1), "normal": (64 * 84 * 10, 1),
              "gumbel": (64 * 84 * 10, 24), "randint": (64 * 84 * 10, 1)}
# hashes per pair, and the bytes the function writes per pair: a subkey is
# two 32-bit words, a 32-bit draw or an int32 four bytes (the port holds
# them in int64; the bound counts what the function needs)
RNG_WORK = {"split": (1, 8), "bits": (1, 4), "uniform": (1, 4),
            "normal": (1, 4), "gumbel": (1, 4), "randint": (4, 4)}
KEY_BYTES = 8  # a key read once: two 32-bit words
# the kernel's grid: at most 132 x 32 blocks of 256 threads, each thread
# striding over the pairs beyond them
GRID_PAIRS = 132 * 32 * 256
# threefry2x32: 20 rounds of an add, a rotate and a xor, and 5 key
# injections of three adds; integer ALU operations issue at a quarter of
# the float32 rate (64 INT32 lanes per SM against 128 FP32 lanes counted
# twice for the multiply-add)
THREEFRY_OPS = 20 * 3 + 5 * 3
INT32_OPS_PER_S = F32_OPS_PER_S / 4


def phase_threefry(dev, log_fn):
    """1b: the threefry kernel (csrc/threefry.cu) against its plain version
    (utils/rng.py on the host) in every mode and epilogue, on 16,384 keys x
    72 draws (1,179,648 pairs, past one pass of the kernel's grid) each,
    plus jax 0.9's frozen draws; then each mode at the main path's shapes:
    bit-equal to its plain version there too, and timed beside it and its
    bound."""
    from symbolicregression_jl_tpu_torch.ops import kernel_rng as kr
    from symbolicregression_jl_tpu_torch.utils import rng

    g = np.random.default_rng(0)
    keys = torch.from_numpy(g.integers(0, 2 ** 32, (16384, 2),
                                       dtype=np.uint64).astype(np.int64))
    keys[:4] = torch.tensor([[0, 0], [2 ** 31, 1], [2 ** 32 - 1, 2 ** 32 - 1],
                             [7, 2 ** 31 + 5]])
    kd = keys.to(dev)
    report = {"bit_equal_share": {}, "max_abs_err": {}, "pairs": {}}

    def check(name, got, ref, exact=True):
        torch.cuda.synchronize()
        got, ref = got.cpu(), ref.cpu()
        if got.dtype in (torch.bfloat16, torch.float16):
            bits_g, bits_r = got.view(torch.int16), ref.view(torch.int16)
        elif got.dtype == torch.float32:
            bits_g, bits_r = got.view(torch.int32), ref.view(torch.int32)
        elif got.dtype == torch.float64:
            bits_g, bits_r = got.view(torch.int64), ref.view(torch.int64)
        else:
            bits_g, bits_r = got, ref
        share = float((bits_g == bits_r).double().mean())
        err = float((got.double() - ref.double()).abs().max())
        report["bit_equal_share"][name] = share
        report["max_abs_err"][name] = err
        report["pairs"][name] = got.numel()
        log_fn(f"threefry {name}: {got.numel()} values, bit-equal share "
               f"{share:.6f}, max abs err {err:.3g}")
        if exact:
            assert share == 1.0, f"threefry {name} differs from its plain version"
        else:  # float64 log: CUDA's against the C library's (ROADMAP C)
            rel = ((got.double() - ref.double()).abs()
                   / ref.double().abs().clamp_min(1e-300)).max()
            assert float(rel) < 1e-11, f"threefry {name}: rel err {rel}"

    D = 72  # 16,384 x 72 pairs: more than one pass of the grid
    assert keys.shape[0] * D > GRID_PAIRS
    check("split", rng.split(kd, D), rng.split(keys, D))
    fold = torch.cat([kd] * (GRID_PAIRS // keys.shape[0] + 1))
    check("fold_in", rng.fold_in(fold, 0x5F3759DF),
          rng.fold_in(fold.cpu(), 0x5F3759DF))
    for w in (8, 16, 32, 64):
        check(f"bits{w}", rng.random_bits(kd, w, (D,)),
              rng.random_bits(keys, w, (D,)))
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
        sfx = kr.DTYPES[dt][1] or "_f32"
        check("uniform" + sfx, rng.uniform(kd, (D,), dt, -0.75, 3.25),
              rng.uniform(keys, (D,), dt, -0.75, 3.25))
        check("normal" + sfx, rng.normal(kd, (D,), dt),
              rng.normal(keys, (D,), dt), dt != torch.float64)
        check("gumbel" + sfx, rng.gumbel(kd, (D,), dt),
              rng.gumbel(keys, (D,), dt), dt != torch.float64)
    check("randint", rng.randint(kd, (D,), 1, torch.tensor(23, device=dev)),
          rng.randint(keys, (D,), 1, 23))
    check("strided keys", rng.uniform(rng.split(kd, 6)[..., 2, :], (3,)),
          rng.uniform(rng.split(keys, 6)[..., 2, :], (3,)))
    # jax 0.9's own draws, frozen
    lit = JAX_LITERALS
    k = rng.key(lit["seed"], dev)
    f32bits = lambda t: t.cpu().view(torch.int32).numpy().astype(
        np.uint32).astype(np.int64).tolist()
    got = {"key": k.cpu().tolist(), "split4": rng.split(k, 4).cpu().tolist(),
           "fold_in": rng.fold_in(k, 0x5F3759DF).cpu().tolist(),
           "bits32": rng.random_bits(k, 32, (8,)).cpu().tolist(),
           "uniform_bits": f32bits(rng.uniform(k, (8,))),
           "normal_bits": f32bits(rng.normal(k, (8,))),
           "gumbel_bits": f32bits(rng.gumbel(k, (8,))),
           "randint": rng.randint(k, (8,), 0, 1000).cpu().tolist(),
           "choice": rng.choice_without_replacement(k, 33, 6).cpu().tolist()}
    for name, v in got.items():
        assert v == lit[name], f"threefry {name} on the card is not jax's: {v}"
    log_fn(f"threefry: the card's draws equal jax 0.9's frozen literals "
           f"({', '.join(got)})")

    # each mode at the main path's shapes: kernel (device time) beside the
    # plain version (host clock; it runs on the host only) and the bound,
    # and the two outputs bit-equal (bits and gumbel there run past one
    # pass of the grid)
    timings = {}
    for mode, (nk, per) in RNG_SHAPES.items():
        kk = kd[:1].expand(nk, 2).contiguous() + torch.arange(
            nk, device=dev).unsqueeze(-1)
        kh = kk.cpu()
        call = {
            "split": lambda k_: rng.split(k_, per),
            "bits": lambda k_: rng.random_bits(k_, 32, (per,)),
            "uniform": lambda k_: rng.uniform(k_),
            "normal": lambda k_: rng.normal(k_),
            "gumbel": lambda k_: rng.gumbel(k_, (per,)),
            "randint": lambda k_: rng.randint(k_, (), 1, 21),
        }[mode]
        ms = device_ms(lambda: call(kk), 50)
        tp = time.time()
        plain_out = call(kh)
        plain_ms = (time.time() - tp) * 1e3
        check(f"{mode} at {nk} x {per}", call(kk), plain_out)
        pairs = nk * per
        hashes, out_bytes = RNG_WORK[mode]
        in_bytes = KEY_BYTES * nk
        byte_ms = (in_bytes + out_bytes * pairs) / HBM_BYTES_PER_S * 1e3
        op_ms = pairs * hashes * THREEFRY_OPS / INT32_OPS_PER_S * 1e3
        timings[mode] = dict(
            keys=nk, per_key=per, ms=ms, plain_ms=plain_ms,
            bound_ms=max(byte_ms, op_ms),
            bound_by="operations" if op_ms > byte_ms else "bytes")
        log_fn(f"threefry {mode} at {nk} x {per}: {ms:.4f} ms on the card, "
               f"plain {plain_ms:.1f} ms on the host, bound "
               f"{timings[mode]['bound_ms']:.5f} ms "
               f"({timings[mode]['bound_by']})")
    report["timings"] = timings
    report["build"] = dict(seconds=kr.BUILD_LOG.get("seconds"),
                           ptxas=[ln.strip() for ln in kr.BUILD_LOG.get(
                               "log", "").splitlines()
                               if "registers" in ln or "spill" in ln])
    return report


# the main path's draw plans at 64 islands x 1000 (B = 84 tournaments of
# 12, 10 attempts, max_len 24, 1 feature, 2 unary and 4 binary operators):
# (plan, root keys, device bounds) of each; the minibatch plan at phase
# 5h(c)'s 64 islands x 50 rows of 2,048; the cycle's and init's plans
# again in float64, as phase 5h(a)'s float64 search draws them
F64_SUFFIX = "_f64"


def main_path_plans():
    from symbolicregression_jl_tpu_torch.models import evolve, fitness
    from symbolicregression_jl_tpu_torch.models import mutate_device as md

    def in_dtype(dt, sfx):
        return {
            "propose" + sfx: (evolve.proposal_plan(84, 1000, 12, dt), 64, {}),
            "mutate" + sfx: (evolve.mutation_plan(1, 2, 4, 24, dt), 64 * 84,
                             {"hi": 21}),
            "crossover" + sfx: (evolve.crossover_plan(24, dt), 64 * 42, {}),
            "random_tree_draws" + sfx: (
                md.single_plan(md.random_tree_draws, 1, 2, 4, 24, dt),
                64 * 1000, {}),
        }

    return {**in_dtype(torch.float32, ""),
            "minibatch": (fitness.minibatch_plan(ROWS, 50, 64), 1, {}),
            **in_dtype(torch.float64, F64_SUFFIX)}


def phase_plans(dev, log_fn):
    """1b (plans): every draw plan of the main path at its shape, on the
    card (one launch of the plan kernel) against its plain version (numpy
    on the host) and against the per-call kernels (one launch per node and
    draw, the route before draw plans), every output bit-equal to both
    (a float64 normal or gumbel draw within 1e-11 of the plain version,
    relative to max(|value|, 1): CUDA's log against the C library's, whose
    last-bit difference is absolute where gumbel's value nears 0; it is
    bit-equal to the per-call kernels, which run the same epilogue); timed
    (device time)
    beside the per-call chain (CUDA events around its launches), the
    plain version and the bound."""
    from symbolicregression_jl_tpu_torch.ops import kernel_rng as kr
    from symbolicregression_jl_tpu_torch.utils import rng

    g = np.random.default_rng(1)
    report = {}
    for name, (plan, n_keys, bound_vals) in main_path_plans().items():
        keys = torch.from_numpy(g.integers(0, 2 ** 32, (n_keys, 2),
                                           dtype=np.uint64).astype(np.int64))
        if n_keys == 1:
            keys = keys[0]
        kd = keys.to(dev)
        bd = {k: torch.tensor(v, device=dev) for k, v in bound_vals.items()}
        bh = {k: torch.tensor(v) for k, v in bound_vals.items()}
        before = kr.PLAN_LAUNCHES.get(plan.name, 0)
        got = plan.run(kd, bd)
        torch.cuda.synchronize()
        assert kr.PLAN_LAUNCHES[plan.name] == before + 1, "one launch a plan"
        calls_before = sum(kr.LAUNCHES.values())
        chain = plan.run_per_call(kd, bd)
        torch.cuda.synchronize()
        chain_launches = sum(kr.LAUNCHES.values()) - calls_before
        tp = time.time()
        plain = plan.run(keys, bh)
        plain_ms = (time.time() - tp) * 1e3
        n_values = n_equal = 0
        max_err = max_rel = 0.0
        for out in got.names():
            a = got[out].cpu()
            kind = plan._draws[plan._names[out]].kind
            log_based = a.dtype == torch.float64 and kind in ("normal",
                                                              "gumbel")
            for ref, what in ((plain[out], "plain version"),
                              (chain[out].cpu(), "per-call kernels")):
                assert a.shape == ref.shape and a.dtype == ref.dtype, (
                    name, out, a.shape, ref.shape)
                ab, rb = (a.view(torch.int32), ref.view(torch.int32)) \
                    if a.dtype == torch.float32 else (
                        (a.view(torch.int64), ref.view(torch.int64))
                        if a.dtype == torch.float64 else (a, ref))
                if what == "plain version":
                    n_equal += int((ab == rb).sum())
                    if a.is_floating_point():
                        diff = (a.double() - ref.double()).abs()
                        max_err = max(max_err, float(diff.max()))
                        max_rel = max(max_rel, float(
                            (diff / ref.double().abs().clamp_min(1.0))
                            .max()))
                    if log_based:
                        continue
                assert torch.equal(ab, rb), (
                    f"plan {name}: {out} differs from the {what}")
            n_values += a.numel()
        log_fn(f"threefry plan {name}: {n_equal} of {n_values} values "
               f"bit-equal to its plain version, max abs err {max_err:.3g}, "
               f"relative to max(|value|, 1) {max_rel:.3g}")
        assert max_rel < 1e-11, f"plan {name}: err {max_rel} to plain"
        ms = device_ms(lambda: plan.run(kd, bd), 50)
        # hundreds of launches do not stay queued behind a spin: the
        # chain's time is CUDA events around its calls, launching included
        chain_ms = cuda_ms(lambda: plan.run_per_call(kd, bd), 3)
        hashes, nbytes = plan.work(n_keys)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = hashes * THREEFRY_OPS / INT32_OPS_PER_S * 1e3
        n_ops = len(plan.compile().words) // rng.OP_WORDS
        report[name] = dict(
            keys=n_keys, axes=list(plan.axes), ops=n_ops,
            draws=len(plan._draws), values=n_values, hashes=hashes,
            bytes=nbytes, ms=ms, per_call_ms=chain_ms,
            per_call_launches=chain_launches, plain_ms=plain_ms,
            bound_ms=max(byte_ms, op_ms),
            bound_by="operations" if op_ms > byte_ms else "bytes",
            max_abs_err=max_err, bit_equal_share=n_equal / n_values)
        log_fn(f"threefry plan {name}: {n_keys} keys x axes {plan.axes}, "
               f"{n_ops} ops, {n_values} values bit-equal to "
               f"{chain_launches} per-call launches; "
               f"{ms:.4f} ms on the card (per-call chain {chain_ms:.4f} ms "
               "with its launching), "
               f"plain {plain_ms:.1f} ms on the host, bound "
               f"{report[name]['bound_ms']:.5f} ms ({report[name]['bound_by']}, "
               f"{hashes} hashes, {nbytes} B)")
    return report


def register_custom_pair():
    """The reference's custom operator pair (tests/test_custom_operators.py
    :22-23), as torch callables."""
    from symbolicregression_jl_tpu_torch import register_binary, register_unary

    register_binary("op2c", lambda x, y: x * x + 1.0 / (y * y + 0.1))
    register_unary("op3c", lambda x: torch.sin(x) + torch.cos(x))


def user_loss(p, t):
    """The reference's loss callable (tests/test_mixed.py:104)."""
    return (p - t) ** 2


def bits_share(got, ref):
    """The share of elements whose bits are equal (NaN counted equal)."""
    if got.numel() == 0:
        return 1.0
    view = torch.int64 if got.element_size() == 8 else torch.int32
    same = (got.view(view) == ref.view(view)) | (
        torch.isnan(got) & torch.isnan(ref))
    return float(same.float().mean())


def phase_user_kernels(dev, log_fn, T=4096):
    """Phase 3f: every kernel with user operators (``+ * op2c``, ``op3c
    cos``) and under the user loss, on 4,096 random trees x 2,048 rows, at
    float32 and in the bfloat16 build, against its plain version on the
    same card tensors; then each user instantiation timed beside the full
    registry instantiation on trees of the same shape (``+ * atan2``,
    ``sin cos``: as many operators, the full instantiation too) and its
    bound. Returns the report."""
    from symbolicregression_jl_tpu_torch.models.trees import UNA
    from symbolicregression_jl_tpu_torch.ops import kernel_eval as ke
    from symbolicregression_jl_tpu_torch.ops import kernel_grad as kg
    from symbolicregression_jl_tpu_torch.ops import kernel_instr as ki
    from symbolicregression_jl_tpu_torch.ops import user_ops
    from symbolicregression_jl_tpu_torch.ops.losses import lp_dist_loss
    from symbolicregression_jl_tpu_torch.ops.operators import (
        is_user_operator, make_operator_set,
    )
    uops = make_operator_set(["+", "*", "op2c"], ["op3c", "cos"])
    rops = make_operator_set(["+", "*", "atan2"], ["sin", "cos"])
    # the registry's operators at the same indices, on the user build (the
    # set's user operators are listed last, so no tree uses them, and the
    # header is ``uops``'s): the instantiation's cost apart from the user
    # operators' own
    rops_u = make_operator_set(["+", "*", "atan2", "op2c"],
                               ["sin", "cos", "op3c"])
    assert ke.uses_full_kernel(uops) and ke.uses_full_kernel(rops)
    loss = user_ops.require_kernel_loss(user_loss)
    # the registry's any-loss instantiation under the same arithmetic
    reg_loss = lp_dist_loss(2.0)
    nfeat = 3
    gen = synthetic_generator(11, dev)
    trees = random_trees(gen, torch.randint(1, 21, (T,), generator=gen, device=dev), nfeat,
        uops, 24, dev)
    Xf = torch.randn((nfeat, ROWS), generator=gen, device=dev) * 1.5
    yf = torch.randn(ROWS, generator=gen, device=dev)
    ls_cval = trees.cval.repeat_interleave(LS_STEPS, 0) * (
        1 + 0.1 * torch.randn((T * LS_STEPS, 24), generator=gen, device=dev))
    report = {"bit_equal_share": {}, "max_rel_err": {}, "max_abs_err": {},
              "timing": {}}

    def check(name, got, ref, rtol, atol):
        got, ref = got.double(), ref.double()
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isfinite(got), fin), f"3f {name}: finite set"
        report["bit_equal_share"][name] = bits_share(got, ref)
        torch.testing.assert_close(got[fin], ref[fin], rtol=rtol, atol=atol)
        rel = ((got - ref).abs() / ref.abs().clamp_min(1e-30))[fin]
        report["max_rel_err"][name] = float(rel.max()) if rel.numel() else 0.0
        report["max_abs_err"][name] = (float((got - ref)[fin].abs().max())
                                       if rel.numel() else 0.0)

    def assert_bits(name, got, ref):
        assert bits_share(got.double(), ref.double()) == 1.0, (
            f"3f {name}: not the same bits")

    for dt in (torch.float32, torch.bfloat16, torch.float64):
        sfx = ke.STORAGE[dt][1]
        X = Xf.to(dt)
        yk, okk = ke.eval_trees(trees, X, uops)
        yk2, _ = ke.eval_trees(trees, X, uops)
        assert_bits(f"B1{sfx} two launches", yk2[okk], yk[okk])
        yp, okp = ke.eval_trees_plain(trees, X, uops)
        assert torch.equal(okk, okp), f"3f B1{sfx}: ok differs"
        assert int(okk.sum()) > 0
        check(f"value{sfx}", yk[okk], yp[okk], 1e-5, 1e-6)
        sk, sok = ke.eval_slot_values(trees, X[:, :1], uops)
        sp, sokp = ke.eval_slot_values_plain(trees, X[:, :1], uops)
        assert torch.equal(sok, sokp), f"3f slots{sfx}: ok differs"
        check(f"slots{sfx}", sk, sp, 1e-5, 1e-6)
        heavy = constant_heavy(trees._replace(cval=trees.cval.to(dt)), gen)
        fk = ke.fold_trees(heavy, uops)
        assert not fold_mismatch(ke.fold_trees(heavy, uops), fk), (
            f"3f fold{sfx}: two launches differ")
        fp = plain_fold(heavy, uops)
        bad = fold_mismatch(fk, fp)
        assert set(bad) <= {"cval"}, f"3f fold{sfx}: {bad}"
        assert int(fk[1].sum()) > T // 2
        check(f"fold{sfx}", fk[0].cval, fp[0].cval, 1e-5, 1e-6)
        for name, packed in (("instr", False), ("instr_packed", True)):
            ik, iok = ki.eval_trees_instr(trees, X, uops, packed)
            assert torch.equal(iok, okk), f"3f {name}{sfx}: ok differs"
            assert_bits(f"{name}{sfx} vs B1", ik[okk], yk[okk])
            ip, iokp = ki.eval_trees_instr_plain(trees, X, uops, packed)
            assert torch.equal(iokp, okk)
            check(f"{name}{sfx}", ik[okk], ip[okk], 1e-5, 1e-6)
        y = yf.to(dt)
        # the kernels' float32 outputs (make_loss_kernel hands them back in
        # the working dtype)
        raw3 = kg.stage_launch(trees, X, y, None, uops, True, 1, loss)
        l3, g3, b3 = raw3(trees.cval)
        ok3 = (b3 == 0) & (trees.length > 0)
        l3b, g3b, _ = raw3(trees.cval)
        assert_bits(f"B3{sfx} two launches, loss", l3b, l3)
        assert_bits(f"B3{sfx} two launches, gradient", g3b, g3)
        lm, gm, okm = kg.eval_loss_grad_program_plain(trees, X, y, None, uops,
                                                      loss=loss)
        assert torch.equal(ok3, okm), f"3f B3{sfx}: ok differs from its mirror"
        fin = okm & torch.isfinite(lm)
        check(f"loss_grad{sfx}", l3[fin], lm[fin], 1e-5, 0)
        _, gs, _, scale = kg.eval_loss_grad_plain(trees, X, y, None, uops,
                                                  scale=True, loss=loss)
        m = fin.unsqueeze(-1) & torch.isfinite(gm) & torch.isfinite(scale)
        g, r = g3.double()[m], gm.double()[m]
        report["bit_equal_share"][f"gradient{sfx}"] = bits_share(g, r)
        report["max_abs_err"][f"gradient{sfx}"] = (
            float((g - r).abs().max()) if g.numel() else 0.0)
        assert bool(((g - r).abs() <= 1e-4 * r.abs() + 1e-5 * scale[m]).all()), (
            f"3f B3{sfx}: gradient beyond the row-sum yardstick")
        for reps in (1, LS_STEPS):
            raw4 = kg.stage_launch(trees, X, y, None, uops, False, reps, loss)
            l4, _, b4 = raw4(trees.cval.repeat_interleave(reps, 0))
            assert torch.equal((b4.reshape(-1, reps) == 0).all(-1)
                               & (trees.length > 0), ok3)
            assert_bits(f"B4{sfx} (reps {reps}) vs B3, loss",
                        l4.reshape(-1, reps)[ok3],
                        l3.unsqueeze(-1).expand(-1, reps)[ok3])
        if dt == torch.float32:
            lk = ke.eval_loss_trees(trees, X, yf, uops, loss)
            lk2 = ke.eval_loss_trees(trees, X, yf, uops, loss)
            assert_bits("B2 two launches", lk2, lk)
            lp = ke.eval_loss_trees_plain(trees, X, yf, uops, loss)
            assert torch.equal(torch.isinf(lk), torch.isinf(lp))
            check("fused", lk[torch.isfinite(lp)], lp[torch.isfinite(lp)],
                  1e-4, 0)
    torch.cuda.synchronize()
    log_fn(f"3f user operators: {T} random trees x {ROWS} rows over + * op2c "
           f"| op3c cos under the loss callable, every kernel against its "
           f"plain version at float32, bfloat16 and float64: bit-equal shares "
           f"{report['bit_equal_share']}, max rel err {report['max_rel_err']}")

    # timing: each user instantiation beside the registry's full one on
    # trees of the same shape, and its bound (bytes over 3.35 TB/s, f32
    # operations over 67 TFLOP/s; a user operator counts its program's
    # primitives, a registry operator one)
    prims = {}
    for arity, names in ((1, uops.unary_names), (2, uops.binary_names)):
        for j, n in enumerate(names):
            prims[(arity, j)] = (sum(
                nd.op not in ("in", "const")
                for nd in user_ops.operator_program(arity, n).nodes)
                if is_user_operator(arity, n) else 1)
    loss_prims = sum(nd.op not in ("in", "const") for nd in loss.program.nodes)

    def node_ops(ops_weighted):
        kind, op = trees.kind, trees.op
        live = torch.arange(24, device=dev) < trees.length.unsqueeze(-1)
        total = 0
        for (arity, j), w in prims.items():
            k = UNA if arity == 1 else UNA + 1
            n = int(((kind == k) & (op == j) & live).sum())
            total += n * (w if ops_weighted else 1)
        return total

    live_slots = int(trees.length.sum())

    def bound(n_ops, bytes_):
        t_b = bytes_ / HBM_BYTES_PER_S * 1e3
        t_o = n_ops / F32_OPS_PER_S * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    for dt in (torch.float32, torch.bfloat16):
        sfx = ke.STORAGE[dt][1]
        el = 4 if dt == torch.float32 else 2
        X = Xf.to(dt)
        y = yf.to(dt)
        in_trees = live_slots * (4 * 4 + el) + T * 16
        rows_in = nfeat * ROWS * el
        entries = [("value", ke.MODE_VALUE, X, None, T * ROWS * el + T * 4)]
        if dt == torch.float32:
            entries.append(("fused", ke.MODE_FUSED, X, yf, T * 8))
        for name, mode, Xm, ym, out_bytes in entries:
            row = {}
            for label, o, lo in (("user", uops, loss),
                                 ("registry", rops, reg_loss),
                                 ("registry_user_build", rops_u, loss)):
                prep = ke.prepare_launch(trees, Xm, ym, o, mode, lo)
                row[f"{label}_ms"] = device_ms(lambda: ke.run_prepared(prep),
                                               30)
            rows = Xm.shape[1]
            n_ops = node_ops(True) * rows + (
                (loss_prims + 1) * T * rows if mode == ke.MODE_FUSED else 0)
            row["bound_ms"], row["bound_by"] = bound(
                n_ops, in_trees + Xm.shape[0] * rows * el + out_bytes
                + (ROWS * 4 if mode == ke.MODE_FUSED else 0))
            row["plain_ms"] = cuda_ms(lambda: (ke.eval_loss_trees_plain(
                trees, X, yf, uops, loss) if mode == ke.MODE_FUSED
                else ke.eval_trees_plain(trees, X, uops)), 1)
            report["timing"][f"{name}{sfx}"] = row
        # the fold kernel (one value per operator node at most)
        tb_f = trees._replace(cval=trees.cval.to(dt))
        row = {}
        for label, o in (("user", uops), ("registry", rops),
                         ("registry_user_build", rops_u)):
            prep = ke.prepare_fold(tb_f, o)
            row[f"{label}_ms"] = device_ms(lambda: ke.run_fold(prep), 30)
        row["bound_ms"], row["bound_by"] = bound(
            node_ops(True), fold_bytes(tb_f, plain_fold(tb_f, uops)[1]))
        row["plain_ms"] = cuda_ms(lambda: plain_fold(tb_f, uops), 1)
        report["timing"][f"fold{sfx}"] = row
        for name, packed in (("instr", False), ("instr_packed", True)):
            row = {}
            for label, o in (("user", uops), ("registry", rops),
                             ("registry_user_build", rops_u)):
                prep = ki.prepare_launch(trees, X, o, packed)
                row[f"{label}_ms"] = device_ms(lambda: ki.run_prepared(prep),
                                               30)
            row["bound_ms"], row["bound_by"] = bound(
                node_ops(True) * ROWS, in_trees + rows_in + T * ROWS * el)
            row["plain_ms"] = cuda_ms(lambda: ki.eval_trees_instr_plain(
                trees, X, uops, packed), 1)
            report["timing"][f"{name}{sfx}"] = row
        for name, with_grad, reps, cv in (("loss_grad", True, 1, trees.cval),
                                          ("loss", False, LS_STEPS, ls_cval)):
            row = {}
            for label, o, lo in (("user", uops, loss),
                                 ("registry", rops, reg_loss),
                                 ("registry_user_build", rops_u, loss)):
                raw = kg.stage_launch(trees, X, y, None, o, with_grad, reps,
                                      lo)
                row[f"{label}_ms"] = device_ms(lambda: raw(cv), 30)
            N = T * reps
            n_ops = (reps * node_ops(True) * ROWS * (2 if with_grad else 1)
                     + N * ROWS * (loss_prims + 2
                                   + (loss_prims + 1 if with_grad else 0)))
            row["bound_ms"], row["bound_by"] = bound(
                n_ops, rows_in + ROWS * (el + 4) + live_slots * 24 + T * 16
                + reps * live_slots * el + N * 8 + (N * 24 * 4 if with_grad
                                                    else 0))
            if with_grad:
                plain = lambda: kg.eval_loss_grad_plain(trees, X, y, None,
                                                        uops, loss=loss)
            else:
                reps_trees = trees.map(
                    lambda f: f.repeat_interleave(reps, 0))._replace(cval=cv)
                plain = lambda: [kg.eval_loss_plain(
                    reps_trees[i:i + 8192], X, y, None, uops, loss=loss)
                    for i in range(0, T * reps, 8192)]
            row["plain_ms"] = cuda_ms(plain, 1)
            report["timing"][f"{name}{sfx}"] = row
    for k, v in report["timing"].items():
        log_fn(f"3f timing {k}: user {v['user_ms']:.4f} ms, registry full "
               f"instantiation {v['registry_ms']:.4f} ms (user / registry "
               f"{v['user_ms'] / v['registry_ms']:.3f}; the registry's "
               f"operators on the user build {v['registry_user_build_ms']:.4f} "
               "ms), bound "
               f"{v['bound_ms']:.5f} ms ({v['bound_by']}), share "
               f"{v['bound_ms'] / v['user_ms']:.4f}, plain {v['plain_ms']:.2f} ms")
    return report


# ---------------------------------------------------------------------------
# Phase 9: tenant-batched serving
# ---------------------------------------------------------------------------

SERVE_T = 64  # tenants of the full-width batch
SERVE_NFEAT, SERVE_ROWS = 5, 256  # each tenant's X
# the reference's default search (15 islands x 33, 550 cycles, BFGS) over
# the serving operators
SERVE_CFG = dict(binary_operators=["+", "-", "*", "/"],
                 unary_operators=["cos", "exp"], maxsize=20, verbosity=0)


def serving_data(seed, T=SERVE_T, weighted=False):
    """T tenants' (X (5, 256), y, weights or None) float32 from ``seed``:
    y_t = a_t cos(x3) + x0^2 - b_t, a_t and b_t drawn from the seed."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 3.0, T)
    b = rng.uniform(-2.0, 2.0, T)
    jobs = []
    for t in range(T):
        X = rng.standard_normal((SERVE_NFEAT, SERVE_ROWS)).astype(np.float32)
        y = (a[t] * np.cos(X[3]) + X[0] ** 2 - b[t]).astype(np.float32)
        w = (rng.uniform(0.5, 1.5, SERVE_ROWS).astype(np.float32)
             if weighted else None)
        jobs.append((X, y, w))
    return jobs


def zero_launch_counts():
    """Every launch count of the kernel wrappers to 0."""
    from symbolicregression_jl_tpu_torch.models import cycle_graph as cg

    for counts in cg.LAUNCH_COUNTERS:
        for k in list(counts):
            counts[k] = 0


def launch_counts():
    """The non-zero launch counts of every kernel wrapper, by counter."""
    from symbolicregression_jl_tpu_torch.ops import kernel_eval as ke
    from symbolicregression_jl_tpu_torch.ops import kernel_grad as kg
    from symbolicregression_jl_tpu_torch.ops import kernel_rng as kr

    return {"eval": {k: v for k, v in ke.LAUNCHES.items() if v},
            "eval_storage": {k: v for k, v in ke.STORAGE_LAUNCHES.items() if v},
            "grad": {k: v for k, v in kg.LAUNCHES.items() if v},
            "grad_storage": {k: v for k, v in kg.STORAGE_LAUNCHES.items() if v},
            "plans": dict(kr.PLAN_LAUNCHES),
            "threefry": {k: v for k, v in kr.LAUNCHES.items() if v}}


class no_plain_versions:
    """Every plain version of a kernel replaced by a raising stub: a card
    tensor that reached one would end the run."""

    def __enter__(self):
        from symbolicregression_jl_tpu_torch.models import mutate_device as tm
        from symbolicregression_jl_tpu_torch.ops import kernel_eval as ke
        from symbolicregression_jl_tpu_torch.ops import kernel_grad as kg
        from symbolicregression_jl_tpu_torch.ops import kernel_instr as ki

        def stub(name):
            def f(*a, **k):
                raise AssertionError(f"the plain version {name} was reached")
            return f

        self.targets = [(ke, "eval_trees_plain"), (ke, "eval_loss_trees_plain"),
                        (ke, "eval_slot_values_plain"),
                        (tm, "simplify_tree_plain"), (kg, "_plain_loss_grad"),
                        (ki, "eval_trees_instr_plain")]
        self.saved = [getattr(m, n) for m, n in self.targets]
        for m, n in self.targets:
            setattr(m, n, stub(n))
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.targets, self.saved):
            setattr(m, n, f)
        return False


def state_leaves(res):
    """A result's first SearchState as one list of tensors: every island
    field, the merged hall of fame and the key."""
    from symbolicregression_jl_tpu_torch.models.cycle_graph import _leaves

    st = res.state[0]
    return _leaves(st.island_states) + _leaves(st.global_hof) + [st.rng_key]


def frontier_of(res):
    return [(c.complexity, c.equation, float(c.loss), float(c.score))
            for c in res.frontier()]


def assert_same_search(name, got, ref):
    """Two searches' states (every island field, the hall of fame, the
    key) and frontiers bit-equal."""
    a, b = state_leaves(got), state_leaves(ref)
    assert len(a) == len(b), name
    differ = [i for i, (x, y) in enumerate(zip(a, b))
              if x.shape != y.shape or not torch.equal(
                  x.view(torch.int8) if x.is_floating_point() else x,
                  y.view(torch.int8) if y.is_floating_point() else y)]
    assert not differ, f"{name}: state fields {differ} of {len(a)} differ"
    assert frontier_of(got) == frontier_of(ref), f"{name}: frontiers differ"
    assert got.num_evals == ref.num_evals, name


def serving_kernels(dev, log_fn):
    """9a: B1-B4 in the per-set form at 64 sets of (5, 256), at the trees
    per set of the serving search (15 islands x 33: 30 children a cycle,
    495 members a rescore, 3 x 15 x 5 = 225 BFGS instances, 8 line-search
    candidates each), each set bit-equal to the same kernel launched on
    that set alone and to its plain version (B2: its mirror under the
    set's launch plan), float32 and bfloat16; then each per-set launch
    timed (device_ms) beside its plain version and its bound. Returns the
    report and the per-kernel timing records."""
    from symbolicregression_jl_tpu_torch.ops import kernel_eval as ke
    from symbolicregression_jl_tpu_torch.ops import kernel_grad as kg
    from symbolicregression_jl_tpu_torch.ops import losses as tl
    from symbolicregression_jl_tpu_torch.ops.operators import make_operator_set

    ops = make_operator_set(SERVE_CFG["binary_operators"],
                            SERVE_CFG["unary_operators"])
    gen = synthetic_generator(90, dev)
    S, nf, R, L = SERVE_T, SERVE_NFEAT, SERVE_ROWS, 24
    X = torch.randn(S, nf, R, generator=gen, device=dev)
    y = torch.randn(S, R, generator=gen, device=dev)
    w = torch.rand(S, R, generator=gen, device=dev) + 0.25
    w[:, ::7] = 0.0  # zero-weight rows, as the job server pads
    per = {"cycle": 30, "rescore": 495, "bfgs": 225}
    trees = {k: random_trees(gen, torch.randint(1, 22, (S * p,), generator=gen,
                                                device=dev), nf, ops, L, dev)
             for k, p in per.items()}
    bits = lambda t: t.view(torch.int16) if t.element_size() == 2 else (
        t.view(torch.int32) if t.element_size() == 4 else t.view(torch.int64))
    share = {}

    def same(name, got, ref, strict=True):
        """bit-equal share of two tensors (NaN payloads included); asserts
        it is 1 when ``strict``."""
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        n_bad = int((bits(got) != bits(ref)).sum())
        s = 1.0 - n_bad / max(got.numel(), 1)
        share[name] = min(share.get(name, 1.0), s)
        assert n_bad == 0 or not strict, f"9a {name}: {n_bad} values differ"
        return s

    def sets_of(tb, p):
        return [tb[s * p:(s + 1) * p] for s in range(S)]

    err = {}

    def note(name, got, ref):
        fin = torch.isfinite(ref) & torch.isfinite(got)
        d = (got[fin].double() - ref[fin].double()).abs()
        err[name] = max(err.get(name, 0.0), float(d.max()) if d.numel() else 0.0)

    for dt in (torch.float32, torch.bfloat16):
        sfx = ke.STORAGE[dt][1]
        Xd, yd = X.to(dt), y.to(dt)
        # B1, the value mode: the cycle's children (the weighted and the
        # 2-byte searches' scoring route)
        tb, p = trees["cycle"], per["cycle"]
        v, ok = ke.eval_trees(tb, Xd, ops)
        alone = [ke.eval_trees(t, Xd[s], ops) for s, t in enumerate(sets_of(tb, p))]
        assert torch.equal(ok, torch.cat([o for _, o in alone]))
        same(f"B1{sfx} per-set vs alone", v[ok], torch.cat([a for a, _ in alone])[ok])
        vp, okp = ke.eval_trees_plain(tb, Xd, ops)
        assert torch.equal(ok, okp)
        same(f"B1{sfx} per-set vs plain", v[ok], vp[ok])
        note(f"value{sfx}", v[ok], vp[ok])
        # B3 and B4: the BFGS instances, unweighted and weighted
        tb, p = trees["bfgs"], per["bfgs"]
        for wt in (None, w):
            tag = "weighted" if wt is not None else "unweighted"
            raw3 = kg.stage_launch(tb, Xd, yd, wt, ops, True, 1)
            l3, g3, b3 = raw3(tb.cval)
            a3 = [kg.stage_launch(t, Xd[s], yd[s], None if wt is None else wt[s],
                                  ops, True, 1)(t.cval)
                  for s, t in enumerate(sets_of(tb, p))]
            same(f"B3{sfx} {tag} per-set vs alone, loss", l3, torch.cat([a[0] for a in a3]))
            same(f"B3{sfx} {tag} per-set vs alone", g3, torch.cat([a[1] for a in a3]))
            assert torch.equal(b3, torch.cat([a[2] for a in a3]))
            lm, gm, okm = kg.eval_loss_grad_program_plain(tb, Xd, yd, wt, ops)
            ok3 = (b3 == 0) & (tb.length > 0)
            assert torch.equal(ok3, okm), f"B3{sfx} ok vs mirror"
            same(f"B3{sfx} {tag} per-set vs mirror, loss", l3[ok3], lm[ok3])
            same(f"B3{sfx} {tag} per-set vs mirror", g3[ok3], gm[ok3])
            note(f"loss_grad{sfx}", g3[ok3], gm[ok3])
            cand = tb.cval.repeat_interleave(LS_STEPS, 0)
            cand = cand * (1 + 0.01 * torch.randn(cand.shape, generator=gen,
                                                  device=dev)).to(cand.dtype)
            raw4 = kg.stage_launch(tb, Xd, yd, wt, ops, False, LS_STEPS)
            l4, _, b4 = raw4(cand)
            a4 = [kg.stage_launch(t, Xd[s], yd[s], None if wt is None else wt[s],
                                  ops, False, LS_STEPS)(
                cand[s * p * LS_STEPS:(s + 1) * p * LS_STEPS])
                for s, t in enumerate(sets_of(tb, p))]
            same(f"B4{sfx} {tag} per-set vs alone", l4, torch.cat([a[0] for a in a4]))
            rep = tb.map(lambda f: f.repeat_interleave(LS_STEPS, 0))._replace(cval=cand)
            lm4, _, okm4 = kg.eval_loss_grad_program_plain(rep, Xd, yd, wt, ops)
            ok4 = (b4 == 0) & (rep.length > 0)
            assert torch.equal(ok4, okm4), f"B4{sfx} ok vs mirror"
            same(f"B4{sfx} {tag} per-set vs mirror", l4[ok4], lm4[ok4])
            note(f"loss{sfx}", l4[ok4], lm4[ok4])
    # B2, the fused mode (float32): the cycle's children and the rescore
    for k in ("cycle", "rescore"):
        tb, p = trees[k], per[k]
        lk = ke.eval_loss_trees(tb, X, y, ops)
        alone = torch.cat([ke.eval_loss_trees(t, X[s], y[s], ops)
                           for s, t in enumerate(sets_of(tb, p))])
        same(f"B2 {k} per-set vs alone", lk, alone)
        plan = ke.launch_plan(p, L, nf, R, ke.MODE_FUSED, False, 0)
        root, bad = ke.eval_program_plain(tb, X, ops)
        sid = ke.set_index(root.shape[0], X)
        lm = tl.contain_nonfinite(ke.fused_sums_plain(root, y[sid], tl.l2_dist_loss, plan)
                                  / R, ~bad & (tb.length > 0))
        assert torch.equal(torch.isinf(lk), torch.isinf(lm)), f"B2 {k}"
        fin = torch.isfinite(lm)
        # the mirror's L2 sums (phase 3d's rule for L2)
        torch.testing.assert_close(lk[fin], lm[fin], atol=0, rtol=1e-6)
        same(f"B2 {k} per-set vs mirror", lk[fin], lm[fin], strict=False)
        note("fused", lk[fin], lm[fin])
    log_fn(f"9a per-set kernels at {S} sets of ({nf}, {R}): bit-equal shares "
           f"{share}; max |err| against the plain versions {err}")

    # timing: each per-set launch alone (device_ms), its plain version and
    # its bound (bytes: X, y, weights of every set, the live slots' fields
    # and constants, the outputs; operations: each operator node per row,
    # the loss per row in the fused and loss kernels)
    def n_op(tb):
        return int((tb.kind >= 3).sum())

    def bound(tb, kind, reps=1, elem=4):
        T = tb.length.shape[0]
        N = T * reps
        live = int(tb.length.sum())
        b_in = S * nf * R * elem + live * (3 * 8 + reps * elem) + T * 16
        if kind in ("fused", "loss_grad", "loss"):
            b_in += S * R * 4 * (2 if kind != "fused" else 1)
        b_out = N * 4 + {"value": N * R * elem, "fused": N * 4,
                         "loss_grad": N * 4 + N * L * 4, "loss": N * 4}[kind]
        row_ops = {"value": 0, "fused": 3, "loss_grad": 4 + 3, "loss": 4}[kind]
        ops_ = (reps * n_op(tb) * R * (2 if kind == "loss_grad" else 1)
                + N * R * row_ops)
        t_b = (b_in + b_out) / HBM_BYTES_PER_S * 1e3
        t_o = ops_ / F32_OPS_PER_S * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    timing = {}
    for name, tb, p in (("value", trees["cycle"], per["cycle"]),
                        ("fused", trees["cycle"], per["cycle"]),
                        ("fused", trees["rescore"], per["rescore"]),
                        ("loss_grad", trees["bfgs"], per["bfgs"]),
                        ("loss", trees["bfgs"], per["bfgs"])):
        if name in ("value", "fused"):
            mode = ke.MODE_VALUE if name == "value" else ke.MODE_FUSED
            prep = ke.prepare_launch(tb, X, y if name == "fused" else None, ops, mode)
            ms = device_ms(lambda: ke.run_prepared(prep), 50)
            plain = (lambda: ke.eval_trees_plain(tb, X, ops)) if name == "value" \
                else (lambda: ke.eval_loss_trees_plain(tb, X, y, ops))
            per_set_loop = [ke.prepare_launch(t, X[s], y[s] if name == "fused" else None,
                                              ops, mode)
                            for s, t in enumerate(sets_of(tb, p))]
            loop_ms = device_ms(lambda: [ke.run_prepared(q) for q in per_set_loop], 2)
            layout = prep.plan._asdict()
            reps = 1
        else:
            reps = 1 if name == "loss_grad" else LS_STEPS
            cv = tb.cval.repeat_interleave(reps, 0)
            raw = kg.stage_launch(tb, X, y, None, ops, name == "loss_grad", reps)
            ms = device_ms(lambda: raw(cv), 50)
            plain = lambda: kg.eval_loss_grad_program_plain(
                tb.map(lambda f: f.repeat_interleave(reps, 0))._replace(cval=cv),
                X, y, None, ops)
            raws = [kg.stage_launch(t, X[s], y[s], None, ops, name == "loss_grad", reps)
                    for s, t in enumerate(sets_of(tb, p))]
            cvs = [t.cval.repeat_interleave(reps, 0) for t in sets_of(tb, p)]
            loop_ms = device_ms(lambda: [r(c) for r, c in zip(raws, cvs)], 2)
            layout = None
        plain_ms = cuda_ms(plain, 2)
        b_ms, b_by = bound(tb, name, reps)
        key = f"{name}@{S}x{p}"
        timing[key] = dict(sets=S, per_set=p, reps=reps, ms=ms, plain_ms=plain_ms,
                           single_set_launches_ms=loop_ms, bound_ms=b_ms,
                           bound_by=b_by, roofline_share=b_ms / ms, layout=layout)
        log_fn(f"9a timing {key}: per-set launch {ms:.4f} ms, {S} single-set "
               f"launches {loop_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
               f"{b_ms:.5f} ms ({b_by}), share {b_ms / ms:.4f}"
               + ("" if layout is None else
                  f"; layout {layout['items']} items of {layout['range']} rows, "
                  f"{layout['warps']} warps, {layout['blocks']} blocks"))
    return dict(bit_equal_share=share, max_abs_err=err), timing


def phase_serving(dev, log_fn, card, seed=0, tenants=SERVE_T, ncycles=550):
    """9: tenant-batched serving (``serving/``): (a) the per-set kernels;
    (b) ``batched_equation_search`` of 64 tenants at the reference's
    default widths, 2 iterations, with every launch counted and every
    plain version a raising stub, tenants 0 and 63 after one iteration
    bit-equal to their solo searches, and the batch's captured cycle
    profiled (device kernels and scoring launches per replay, host waits),
    unweighted and weighted (the job server's path), beside a solo's;
    (c) 4 tenants x 2 iterations x 50 cycles, weighted, with
    ``batching=True``, with ``independent_island_batches`` and at
    bfloat16, each tenant bit-equal to its solo search; (d) the
    ``JobServer`` on six jobs of two buckets, each result bit-equal to the
    batched search of its bucket's padded data."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from symbolicregression_jl_tpu_torch import (
        JobServer, batched_equation_search, equation_search, make_options,
    )
    from symbolicregression_jl_tpu_torch import api as api_mod
    from symbolicregression_jl_tpu_torch.models import cycle_graph as cg
    from symbolicregression_jl_tpu_torch.models.dataset import (
        make_dataset, update_baseline_loss,
    )
    from symbolicregression_jl_tpu_torch.models.fitness import score_dtype
    from symbolicregression_jl_tpu_torch.ops import kernel_eval as ke
    from symbolicregression_jl_tpu_torch.tools.kernel_breakdown import sync_counts

    t_phase = time.time()
    report = {}
    report["kernels"], kernel_timing = serving_kernels(dev, log_fn)
    report["kernels"]["seconds"] = time.time() - t_phase

    # ---- (b) the engine at full width -------------------------------------
    jobs = serving_data(seed, T=tenants)
    seeds = [1000 + t for t in range(tenants)]
    opts = make_options(seed=0, ncycles_per_iteration=ncycles, **SERVE_CFG)
    cg.clear_cache()
    tb0 = time.time()
    with no_plain_versions():
        one = batched_equation_search(jobs, options=opts, seeds=seeds,
                                      niterations=1, return_state=True)
        torch.cuda.synchronize()
        one_s = time.time() - tb0
        solo_its = {}
        for t in (0, tenants - 1):
            stamps = []
            ts = time.time()
            X_t, y_t, _ = jobs[t]
            solo = equation_search(
                X_t, y_t, options=dataclasses.replace(opts, seed=seeds[t]),
                niterations=2 if t == 0 else 1, return_state=True,
                on_iteration=lambda j, it, c: stamps.append(time.time()))
            torch.cuda.synchronize()
            solo_its[t] = [stamps[0] - ts] + [b - a for a, b in zip(stamps, stamps[1:])]
            if t == 0:  # its first iteration's state, for the check below
                solo1 = equation_search(
                    X_t, y_t, options=dataclasses.replace(opts, seed=seeds[t]),
                    niterations=1, return_state=True)
            else:
                solo1 = solo
            assert_same_search(f"9b tenant {t} after 1 iteration", one[t], solo1)
    log_fn(f"9b: tenants 0 and {tenants - 1} of the {tenants}-tenant batch "
           f"bit-equal to their solo searches after 1 iteration (every island "
           f"field, the hall of fame, the key, the frontier); 1-iteration batch "
           f"{one_s:.2f} s (init and capture included); solo s per iteration "
           f"{solo_its}")
    # 2 iterations, counts zeroed just before and read just after, each
    # iteration timed to its end on the card
    it_s = []
    plain_iterate = api_mod._iterate

    def timed_iterate(*a, **k):
        t_i = time.time()
        out = plain_iterate(*a, **k)
        torch.cuda.synchronize()
        it_s.append(time.time() - t_i)
        return out

    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    api_mod._iterate = timed_iterate
    t2 = time.time()
    try:
        with no_plain_versions():
            two = batched_equation_search(jobs, options=opts, seeds=seeds,
                                          niterations=2, return_state=True)
            torch.cuda.synchronize()
    finally:
        api_mod._iterate = plain_iterate
    batch_s = time.time() - t2
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    graphs = [g for g in cg._CACHE.values() if g.X.dim() == 3]
    (bg,) = graphs
    ncyc = opts.ncycles_per_iteration
    assert bg.replays >= 2 * ncyc, bg.replays
    delta = dict(zip(map(id, cg.LAUNCH_COUNTERS), bg.launch_delta))
    scoring_per_replay = {k: v for k, v in delta[id(ke.LAUNCHES)].items() if v}
    # one scoring launch per replayed cycle for all 64 tenants (float32,
    # unweighted: B2's fused mode), and one fold launch
    assert scoring_per_replay == {"fused": 1, "fold": 1}, scoring_per_replay
    # init (1) + 2 x (550 cycles + 1 rescore) B2 launches for the batch;
    # BFGS: 9 B3 and 8 B4 launches per iteration for every tenant
    assert counts["eval"].get("fused") == 1 + 2 * (ncyc + 1), counts
    assert counts["grad"] == {"loss_grad": 18, "loss": 16}, counts
    assert all(np.isfinite(r.best_loss().loss) for r in two)
    assert all(r.iterations == 2 for r in two)
    best = [float(r.best_loss().loss) for r in two]
    log_fn(f"9b: batch of {tenants} tenants x 15 islands x 33, 2 iterations "
           f"of {ncyc} cycles in {batch_s:.2f} s: {it_s} s per iteration "
           f"(solo: {solo_its[0]} s per iteration); launches {counts}; peak "
           f"{peak / 2**20:.1f} MiB; per replayed cycle {scoring_per_replay}; "
           f"best loss per tenant min {min(best):.3g} max {max(best):.3g}")
    # the captured cycle of the batch and of one solo search: ms per replay
    # (A B B A over 50 replays), device kernels and host waits per replay
    Xb = torch.stack([torch.as_tensor(X_t, device=dev) for X_t, _, _ in jobs])
    yb = torch.stack([torch.as_tensor(y_t, device=dev) for _, y_t, _ in jobs])
    bl = torch.tensor([update_baseline_loss(make_dataset(X_t, y_t, device=dev),
                                            opts).baseline_loss
                       for X_t, y_t, _ in jobs],
                      dtype=score_dtype(torch.float32), device=dev)
    from symbolicregression_jl_tpu_torch.models.evolve import _map_tensors

    # the 64 tenants' island states, tenant-major, as the batch holds them
    parts = [r.state[0].island_states for r in two]
    leaves_b = iter([torch.cat(ls) for ls in zip(*[cg._leaves(p) for p in parts])])
    st_b = _map_tensors(lambda _: next(leaves_b), parts[0])
    topts = dataclasses.replace(opts, tenants=tenants)
    solo_st = two[0].state[0].island_states
    X0 = Xb[0]
    y0 = yb[0]
    bl0 = float(bl[0])

    # the served path: the job server pads every job with explicit
    # weights, so its batches score through B1 and the weighted loss
    wb = torch.as_tensor(np.random.default_rng(seed + 3).uniform(
        0.5, 1.5, tuple(yb.shape)).astype(np.float32), device=dev)

    def replay(which, n):
        if which in ("batch", "weighted"):
            return cg.s_r_cycle_islands_graph(
                st_b, opts.maxsize, Xb, yb, wb if which == "weighted" else None,
                bl, topts, ncycles=n)
        return cg.s_r_cycle_islands_graph(solo_st, opts.maxsize, X0, y0, None,
                                          bl0, opts, ncycles=n)

    cyc_ms = {"batch": [], "weighted": [], "solo": []}
    for which in ("batch", "weighted", "solo", "solo", "weighted", "batch"):
        cyc_ms[which].append(cuda_ms(lambda: replay(which, 50), 1) / 50)
    (wg,) = [g for g in cg._CACHE.values()
             if g.X.dim() == 3 and g.weights is not None]
    w_delta = dict(zip(map(id, cg.LAUNCH_COUNTERS), wg.launch_delta))
    weighted_per_replay = {k: v for k, v in w_delta[id(ke.LAUNCHES)].items()
                           if v}
    # one value-mode launch per replayed cycle for all 64 weighted tenants
    assert weighted_per_replay == {"value": 1, "fold": 1}, weighted_per_replay
    prof_n = 10
    replay_stats = {}
    for which in ("batch", "weighted", "solo"):
        replay(which, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            replay(which, prof_n)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        from torch.autograd import DeviceType
        attr = ("self_device_time_total"
                if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
        ev = [e for e in ka if e.device_type == DeviceType.CUDA]
        n_k = sum(e.count for e in ev)
        busy = sum(getattr(e, attr) for e in ev) / 1e3
        by_call, by_op = sync_counts(prof)
        waits = {k: n for k, n in by_op.items()
                 if "Synchronize" in k and " <- None " not in k}
        replay_stats[which] = dict(
            kernels_per_replay=n_k / prof_n, device_busy_ms_per_replay=busy / prof_n,
            host_waits_per_replay=sum(waits.values()) / prof_n)
        assert not waits, f"9b {which}: the replayed cycle waits for the card {waits}"
        assert n_k > 0
    log_fn(f"9b captured cycle ({card}): ms per replay {cyc_ms} (A B C C B A, "
           f"50 replays each; weighted: the {tenants} tenants with weights, "
           f"launches per replay {weighted_per_replay}); {replay_stats}")
    report["engine"] = dict(
        tenants=tenants, islands=15, npop=33, ncycles=ncyc, iterations=2,
        batch_s=batch_s, s_per_iteration=it_s, one_iteration_batch_s=one_s,
        solo_s_per_iteration=solo_its, launches=counts,
        scoring_launches_per_replay=scoring_per_replay, peak_bytes=peak,
        weighted_launches_per_replay=weighted_per_replay,
        ms_per_replay=cyc_ms, replay=replay_stats,
        captures=bg.captures, replays=bg.replays, capture_s=bg.capture_s,
        pool_bytes=bg.pool_bytes, best_loss=best)
    del one, two, solo, solo1, st_b, parts, solo_st
    cg.clear_cache()

    # ---- (c) bit-identity variants at 4 tenants ---------------------------
    variants = {"weighted": dict(), "batching": dict(batching=True, batch_size=50),
                "independent_island_batches": dict(
                    batching=True, batch_size=50, independent_island_batches=True),
                "bfloat16": dict(precision="bfloat16")}
    report["variants"] = {}
    for name, kw in variants.items():
        tv = time.time()
        vjobs = serving_data(seed + 1, T=4, weighted=name == "weighted")
        vopts = make_options(seed=0, ncycles_per_iteration=50, **SERVE_CFG, **kw)
        vseeds = [7, 8, 9, 10]
        zero_launch_counts()
        with no_plain_versions():
            got = batched_equation_search(vjobs, options=vopts, seeds=vseeds,
                                          niterations=2, return_state=True)
            vcounts = launch_counts()
            for t, (X_t, y_t, w_t) in enumerate(vjobs):
                ref = equation_search(X_t, y_t, weights=w_t, niterations=2,
                                      options=dataclasses.replace(vopts, seed=vseeds[t]),
                                      return_state=True)
                assert_same_search(f"9c {name} tenant {t}", got[t], ref)
        report["variants"][name] = dict(s=time.time() - tv, launches=vcounts)
        log_fn(f"9c {name}: 4 tenants x 2 iterations x 50 cycles, each tenant "
               f"bit-equal to its solo search; batch launches {vcounts} "
               f"({time.time() - tv:.1f} s with the solo searches)")
        cg.clear_cache()

    # ---- (d) the job server ------------------------------------------------
    td = time.time()
    rng = np.random.default_rng(seed + 2)
    shapes = [(2, 97), (2, 120), (2, 128), (5, 260), (5, 290), (5, 300)]
    dopts = make_options(seed=0, ncycles_per_iteration=20, **SERVE_CFG)
    server = JobServer(dopts, niterations=1, max_tenants=4)
    submitted = {}
    for i, (nf, n) in enumerate(shapes):
        Xj = rng.standard_normal((nf, n)).astype(np.float32)
        yj = (Xj[0] ** 2 - np.cos(Xj[-1])).astype(np.float32)
        jid = server.submit(Xj, yj, seed=100 + i, job_id=f"job{i}")
        submitted[jid] = i
    assert server.stats()["buckets"] == 2, server.stats()
    with no_plain_versions():
        done = server.drain()
        by_bucket = {}
        for r in done:
            by_bucket.setdefault(r.bucket, []).append(r)
        assert len(by_bucket) == 2 and server.pending() == 0
        # each job's arrays again, in submission order
        rng = np.random.default_rng(seed + 2)
        arrays = []
        for nf, n in shapes:
            Xj = rng.standard_normal((nf, n)).astype(np.float32)
            arrays.append((Xj, (Xj[0] ** 2 - np.cos(Xj[-1])).astype(np.float32)))
        for bucket, rs in by_bucket.items():
            n_pad, f_pad = bucket[0], bucket[1]
            padded, jseeds = [], []
            for r in rs:
                i = submitted[r.job_id]
                Xj, yj = arrays[i]
                Xp = np.zeros((f_pad, n_pad), np.float32)
                Xp[:Xj.shape[0], :Xj.shape[1]] = Xj
                yp = np.zeros(n_pad, np.float32)
                yp[:len(yj)] = yj
                wp = np.zeros(n_pad, np.float32)
                wp[:len(yj)] = 1.0
                padded.append((Xp, yp, wp))
                jseeds.append(100 + i)
            ref = batched_equation_search(padded, options=dopts, seeds=jseeds,
                                          niterations=1)
            for r, rr in zip(rs, ref):
                assert frontier_of(r.result) == frontier_of(rr), r.job_id
                assert r.result.num_evals == rr.num_evals, r.job_id
    report["job_server"] = dict(
        s=time.time() - td, stats=server.stats(),
        jobs={r.job_id: dict(bucket=list(r.bucket[:2]), tenants=r.tenants,
                             latency_s=r.latency_s) for r in done})
    log_fn(f"9d JobServer: 6 jobs in 2 buckets {sorted(set(r.bucket[:2] for r in done))}, "
           f"max_tenants 4, drained in {time.time() - td:.1f} s with the checks; "
           f"each result bit-equal to the batched search of its bucket's "
           f"padded data; {server.stats()}")
    cg.clear_cache()
    report["seconds"] = time.time() - t_phase
    log_fn(f"phase 9: {report['seconds']:.1f} s")
    return report, kernel_timing


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncycles", type=int, default=550,
                    help="cycles per iteration of the main-path search")
    ap.add_argument("--niterations", type=int, default=2)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available; nothing was run")
        return 2
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.models import cycle_graph as cg
    from symbolicregression_jl_tpu_torch.models.trees import (
        BIN, CONST, VAR, TreeBatch, UNA, encode_tree, parse_expression, stack_trees,
    )
    from symbolicregression_jl_tpu_torch.ops import kernel_eval as ke
    from symbolicregression_jl_tpu_torch.ops import kernel_grad as kg
    from symbolicregression_jl_tpu_torch.ops import kernel_instr as ki
    from symbolicregression_jl_tpu_torch.ops import losses as tlosses
    from symbolicregression_jl_tpu_torch.ops import user_ops
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_REGISTRY, UNARY_REGISTRY, is_user_operator, make_operator_set,
    )
    from symbolicregression_jl_tpu_torch.ops import kernel_rng as kr
    from symbolicregression_jl_tpu_torch.utils import rng as keyrng

    dev = torch.device("cuda")
    t0 = time.time()

    # ---- 1. card and build ------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    cpu = host_cpu()
    log(f"host: {cpu}")
    tb = time.time()
    # one nvcc process per source and working dtype (float32, bfloat16,
    # float16: nine libraries), all started together, and with them the
    # libraries of the generated headers the user operators and the loss
    # callable of phases 3f, 5g and 8 need: the set's operators alone (the
    # value and slot modes, B5 / B6), with the loss (B2, B3, B4), and phase
    # 8's two searches' (``op3c`` alone; the loss over registry operators)
    register_custom_pair()
    uops = make_operator_set(["+", "*", "op2c"], ["op3c", "cos"])
    uloss = user_ops.require_kernel_loss(user_loss)
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    h_ops, h_loss, h_op3c, h_mixed = (
        user_ops.user_build(uops), user_ops.user_build(uops, uloss),
        user_ops.user_build(make_operator_set(["+", "*"], ["op3c"])),
        user_ops.user_build(make_operator_set(["+", "-", "*"], ["cos"]),
                            uloss))
    # the float64 builds' headers (double device code: their own hashes)
    h_ops64 = user_ops.user_build(uops, None, True)
    h_loss64 = user_ops.user_build(uops, uloss, True)
    user_libs = [(ke, f32, h_ops), (ke, bf16, h_ops), (ki, f32, h_ops),
                 (ki, bf16, h_ops), (ke, f32, h_loss), (kg, f32, h_loss),
                 (kg, bf16, h_loss), (ke, f32, h_op3c), (kg, f32, h_op3c),
                 (ke, f32, h_mixed), (kg, f32, h_mixed), (ke, f64, h_ops64),
                 (ki, f64, h_ops64), (kg, f64, h_loss64)]
    builds = [(m, d) for d in ke.STORAGE for m in (ke, kg, ki)]
    with ThreadPoolExecutor(len(builds) + len(user_libs) + 1) as pool:
        for f in ([pool.submit(m.build_library, True, d) for m, d in builds]
                  + [pool.submit(m.build_library, True, d, u)
                     for m, d, u in user_libs]
                  + [pool.submit(kr.build_library, True)]):
            f.result()
    build_s = time.time() - tb
    log(f"build: nvcc {build_s:.1f} s for the three sources x four dtypes, "
        f"{len(user_libs)} libraries of generated headers and the threefry "
        f"kernel ({kr.BUILD_LOG['seconds']:.1f} s)")
    for line in kr.BUILD_LOG["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"ptxas threefry: {line.strip()}")

    # ---- 1b. the threefry kernel vs plain, and jax's frozen draws ---------
    rng_report = phase_threefry(dev, log)
    plan_report = phase_plans(dev, log)
    nvcc_s = {}
    for d in ke.STORAGE:
        for name, m in (("postfix_eval", ke), ("postfix_grad", kg),
                        ("instr_eval", ki)):
            lib = f"{name}{ke.STORAGE[d][1]}"
            nvcc_s[lib] = m.BUILD_SECONDS[d]
            log(f"build {lib}: nvcc {m.BUILD_SECONDS[d]:.1f} s")
            for line in m.BUILD_LOGS[d].splitlines():
                if ("registers" in line or "spill" in line or "smem" in line
                        or "Compiling entry" in line):
                    log(f"ptxas {lib}: {line.strip()}")
    src_name = {ke: "postfix_eval", kg: "postfix_grad", ki: "instr_eval"}
    for m, d, u in user_libs:
        lib = f"{src_name[m]}_u{u.key}{ke.STORAGE[d][1]}"
        nvcc_s[lib] = m.BUILD_SECONDS[(d, u.key)]
        log(f"build {lib}: nvcc {nvcc_s[lib]:.1f} s")
        for line in m.BUILD_LOGS[(d, u.key)].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {lib}: {line.strip()}")

    # ---- 2. scoring kernel vs plain at the main path's shapes -------------
    ops = make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    X_np, y_np = feynman_data()
    X = torch.tensor(X_np, device=dev)
    y = torch.tensor(y_np, device=dev)
    gen = synthetic_generator(1, dev)
    sizes = torch.randint(3, 21, (T_RESCORE,), generator=gen, device=dev)
    trees = random_trees(gen, sizes, 1, ops, 24, dev)
    poison = [parse_expression(s, ops) for s in (
        "x0 / (x0 - x0)", "exp(exp(exp(exp(x0))))", "(x0 * 0.5) / (x0 - x0)",
        "cos(x0) + exp(exp(exp(exp(x0 + 1.5))))")]
    pt = stack_trees([encode_tree(e, 24, device=dev) for e in poison])
    # bare leaves (one IDENT step of the instruction program) and a unary
    # chain (no leaf to drop) just before the poisoning trees
    edge = stack_trees([encode_tree(parse_expression(s, ops), 24, device=dev)
                        for s in ("0.5", "x0", "cos(" * 9 + "x0" + ")" * 9)])
    trees = TreeBatch(*(torch.cat([a[: T_RESCORE - 7], e, b]) for a, e, b in
                        zip(trees, edge, pt)))
    cycle = trees[T_RESCORE - T_CYCLE:]  # includes the poisoning trees
    err = {"value": 0.0, "fused": 0.0, "slots": 0.0, "fold": 0.0}
    rel = dict(err)

    def note(name, got, ref):
        if got.numel() == 0:
            return
        err[name] = max(err[name], float((got - ref).abs().max()))
        rel[name] = max(rel[name], float(((got - ref).abs()
                                          / ref.abs().clamp_min(1e-30)).max()))

    def ulp_mismatch(got, ref):
        """(count, max ulp distance) of the elements whose bits differ."""
        gi, ri = got.view(torch.int32).long(), ref.view(torch.int32).long()
        diff = gi != ri
        n = int(diff.sum())
        return n, int((gi - ri).abs()[diff].max()) if n else 0

    def assert_bits(name, got, ref):
        n, ulp = ulp_mismatch(got, ref)
        assert n == 0, f"{name}: {n} values differ, max {ulp} ulp"

    def check_value(tb_):
        yk, okk = ke.eval_trees(tb_, X, ops)
        yp, okp = ke.eval_trees_plain(tb_, X, ops)
        assert torch.equal(okk, okp), "value mode: ok differs"
        assert int((~okk).sum()) >= 4, "poisoning trees were not poisoned"
        torch.testing.assert_close(yk[okk], yp[okk], rtol=1e-5, atol=1e-6)
        assert_bits("value mode vs plain", yk[okk], yp[okk])
        note("value", yk[okk], yp[okk])

    def check_fused(tb_, chunk=8192):
        lk = ke.eval_loss_trees(tb_, X, y, ops)
        assert_bits("fused: two launches", ke.eval_loss_trees(tb_, X, y, ops), lk)
        lp = torch.cat([ke.eval_loss_trees_plain(tb_[i:i + chunk], X, y, ops)
                        for i in range(0, tb_.length.shape[0], chunk)])
        assert torch.equal(torch.isinf(lk), torch.isinf(lp)), "fused: inf differs"
        fin = torch.isfinite(lp)
        torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-4, atol=0)
        note("fused", lk[fin], lp[fin])

    X1 = torch.zeros((1, 1), device=dev)

    def check_slots(tb_):
        sk, _ = ke.eval_slot_values(tb_, X1, ops)
        sp, _ = ke.eval_slot_values_plain(tb_, X1, ops)
        fin = torch.isfinite(sp)
        assert torch.equal(torch.isfinite(sk), fin), "slots: finite set differs"
        torch.testing.assert_close(sk[fin], sp[fin], rtol=1e-5, atol=1e-6)
        assert_bits("slot values vs plain", sk[fin], sp[fin])
        note("slots", sk[fin], sp[fin])

    fold_report = {}

    def check_fold(tb_, opsc, label, exact=True, chunk=8192):
        """The fold kernel (``simplify_tree`` on the card) against the
        plain fold on the same card tensors: every field and ``changed``
        bit for bit (with ``exact`` False, the 44 operators, whose torch
        and CUDA bodies differ in an ulp, the structure exactly and the
        constants within rtol 1e-5), and two launches the same bits.
        Returns the number of trees it changed."""
        got = ke.fold_trees(tb_, opsc)
        again = fold_mismatch(ke.fold_trees(tb_, opsc), got)
        assert not again, f"fold {label}: two launches differ: {again}"
        ref = plain_fold(tb_, opsc, chunk)
        bad = fold_mismatch(got, ref)
        if exact:
            assert not bad, f"fold {label}: differs from the plain fold: {bad}"
        else:
            assert set(bad) <= {"cval"}, f"fold {label}: {bad}"
            torch.testing.assert_close(got[0].cval, ref[0].cval, rtol=1e-5,
                                       atol=1e-6, equal_nan=True)
        fin = torch.isfinite(ref[0].cval)
        note("fold", got[0].cval[fin].double(), ref[0].cval[fin].double())
        n_changed = int(got[1].sum())
        fold_report[label] = dict(
            trees=int(tb_.length.shape[0]), max_len=tb_.max_len,
            changed=n_changed, cval_bits_differ=bad.get("cval", 0))
        return n_changed

    for name in ("instr", "instr_packed"):
        err[name] = rel[name] = 0.0

    def check_instr(tb_, Xc, opsc, label, chunk=8192):
        """B5 and B6: ok equal to the postfix value mode's and values
        bit-equal to it where ok; against the plain version at rtol 1e-5 /
        atol 1e-6."""
        yv, okv = ke.eval_trees(tb_, Xc, opsc)
        for name, packed in (("instr", False), ("instr_packed", True)):
            yk, okk = ki.eval_trees_instr(tb_, Xc, opsc, packed)
            assert torch.equal(okk, okv), (
                f"{name} {label}: ok differs from the value mode at "
                f"{int((okk != okv).sum())} trees")
            n, ulp = ulp_mismatch(yk[okv], yv[okv])
            if n:
                log(f"{name} {label}: {n} values differ from the postfix value "
                    f"mode, max {ulp} ulp")
            assert n == 0, f"{name} {label}: not bit-equal to the value mode"
            for i in range(0, tb_.length.shape[0], chunk):
                yp, okp = ki.eval_trees_instr_plain(tb_[i:i + chunk], Xc, opsc,
                                                    packed)
                assert torch.equal(okp, okk[i:i + chunk]), f"{name}: ok vs plain"
                torch.testing.assert_close(yk[i:i + chunk][okp], yp[okp],
                                           rtol=1e-5, atol=1e-6)
                note(name, yk[i:i + chunk][okp], yp[okp])
        return int(okv.sum())

    check_value(cycle)
    check_fused(cycle)
    check_fused(trees)
    check_slots(cycle)
    check_slots(trees)
    fgen = synthetic_generator(5, dev)
    for tb_ in (cycle, trees):
        T = tb_.length.shape[0]
        assert check_fold(tb_, ops, f"search-like@{T}") > 0
        heavy = constant_heavy(tb_, fgen)
        assert check_fold(heavy, ops, f"constant-heavy@{T}") > T // 2
        check_slots(heavy)
    for tb_ in (cycle, trees):
        n_ok = check_instr(tb_, X, ops, f"T={tb_.length.shape[0]}")
        log(f"instr kernels T={tb_.length.shape[0]}: ok equal and values "
            f"bit-equal to the postfix value mode ({n_ok} trees not poisoned)")
    torch.cuda.synchronize()
    log(f"kernel vs plain: agree at T={T_CYCLE} and T={T_RESCORE} x {ROWS} "
        f"rows; max abs err {err}; max rel err {rel}")
    log(f"fold kernel vs plain fold: every field and changed bit-equal, two "
        f"launches the same bits: {fold_report}")

    # invalid programs (stack underflow, unfinished, a length beyond L, a
    # negative length, an operator outside the set, an unknown kind, a
    # feature out of range): every kernel and every plain version report
    # each one poisoned, its value and slot values 0 and its loss +inf
    shapes_ = [([VAR, BIN], 2), ([VAR, VAR], 2), ([UNA], 1), ([VAR], 25),
               ([VAR], -1), ([VAR, VAR, BIN], 3), ([7], 1), ([VAR], 1)]
    kind_ = torch.tensor([r + [0] * (24 - len(r)) for r, _ in shapes_],
                         device=dev)
    op_, feat_ = torch.zeros_like(kind_), torch.zeros_like(kind_)
    op_[5, 2] = ops.n_binary
    feat_[7, 0] = X.shape[0]
    invalid = TreeBatch(kind_, op_, feat_, torch.full(kind_.shape, 0.5,
                                                      device=dev),
                        torch.tensor([n for _, n in shapes_], device=dev))
    assert bool(ke.runnable(invalid, ops, X.shape[0])[1].all())
    for fn in (ke.eval_trees, ke.eval_trees_plain):
        yv, okv = fn(invalid, X, ops)
        assert not okv.any() and not yv.any(), fn.__name__
    for fn in (ke.eval_loss_trees, ke.eval_loss_trees_plain):
        assert bool(torch.isposinf(fn(invalid, X, y, ops)).all()), fn.__name__
    for fn in (ke.eval_slot_values, ke.eval_slot_values_plain):
        sv, oks = fn(invalid, X1, ops)
        assert not oks.any() and not sv.any(), fn.__name__
    # the fold leaves an invalid program as it was (the last, a VAR leaf
    # whose feature is out of range, is a valid program to the fold, which
    # reads no feature, and has nothing to fold)
    assert check_fold(invalid, ops, "invalid") == 0
    for packed in (False, True):
        for fn in (ki.eval_trees_instr, ki.eval_trees_instr_plain):
            yv, okv = fn(invalid, X, ops, packed)
            assert not okv.any() and not yv.any(), (fn.__name__, packed)
    for Xc, yc in ((X, y), (X.cpu(), y.cpu())):
        tb_ = invalid.map(lambda f: f.to(Xc.device))
        _, gk, okg = kg.eval_loss_grad(tb_, Xc, yc, None, ops)
        assert not okg.any() and not gk.any(), Xc.device
        assert not kg.eval_loss(tb_, Xc, yc, None, ops)[1].any(), Xc.device
    log(f"invalid programs: {len(shapes_)} poisoned by every kernel and "
        "every plain version")

    # ---- 3. constant-optimisation kernel vs plain ---------------------------
    # one BFGS step's instances: the same random trees and poisoning trees;
    # the line search runs each tree's structure for 8 perturbed constant
    # vectors
    opt_trees = TreeBatch(*(torch.cat([a[: T_OPT - 4], b]) for a, b in
                            zip(trees, pt)))
    w_zero = torch.rand(ROWS, generator=gen, device=dev) + 0.5
    w_zero[:64] = 0.0  # zero-weight rows
    ls_cval = opt_trees.cval.repeat_interleave(LS_STEPS, 0) * (
        1 + 0.1 * torch.randn((T_OPT * LS_STEPS, 24), generator=gen, device=dev))
    ls_trees = opt_trees.map(
        lambda f: f.repeat_interleave(LS_STEPS, 0))._replace(cval=ls_cval)
    for name in ("loss_grad", "loss"):
        err[name] = rel[name] = 0.0

    def check_losses(name, lk, okk, lp, okp, min_poisoned=4):
        assert torch.equal(okk, okp), f"{name}: ok differs"
        assert int((~okk).sum()) >= min_poisoned, "poisoning trees were not poisoned"
        fin = okp & torch.isfinite(lp)
        assert torch.equal(okp & torch.isfinite(lk), fin), f"{name}: inf differs"
        torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-5, atol=0)
        note(name, lk[fin], lp[fin])

    def check_grad(weights, chunk=4096, tb_=opt_trees, Xc=X, yc=y, opsc=ops,
                   min_poisoned=4, mirror=False):
        """Two launches give the same bits, and the loss is the loss-only
        kernel's in every bit; with ``mirror`` the loss, gradients and
        flags are the plain mirror's (``eval_loss_grad_program_plain``:
        the same operations, the same order of the sums) in every bit.
        Gradients, against the sum over rows of the terms' magnitudes
        (``scale``, float32): where a term is NaN both are NaN; where
        ``scale`` is finite no partial sum in any order overflows, so both
        are finite and agree within rtol 1e-4 plus 1e-5 of ``scale`` (both
        sum 2,048 rows in float32, in different orders, and terms of both
        signs cancel); where ``scale`` overflowed the result depends on
        the order of the sum and is only counted."""
        lk, gk, okk = kg.eval_loss_grad(tb_, Xc, yc, weights, opsc)
        lk2, gk2, okk2 = kg.eval_loss_grad(tb_, Xc, yc, weights, opsc)
        assert torch.equal(okk, okk2), "gradient: two launches, ok differs"
        assert_bits("gradient: two launches, loss", lk2, lk)
        assert_bits("gradient: two launches, gradient", gk2, gk)
        # the loss-only kernel's loss for the same constants, in its
        # one-candidate layout and in the line search's (8 per tree)
        for reps in (1, LS_STEPS):
            fn = kg.make_loss_kernel(tb_, Xc, yc, weights, opsc,
                                     with_grad=False, reps=reps)
            l4, _, ok4 = fn(tb_.cval.repeat_interleave(reps, 0))
            assert torch.equal(ok4.reshape(-1, reps),
                               okk.unsqueeze(-1).expand(-1, reps)), reps
            assert_bits(f"gradient vs loss-only kernel (reps {reps}), loss",
                        l4.reshape(-1, reps),
                        lk.unsqueeze(-1).expand(-1, reps).contiguous())
        outs = [kg.eval_loss_grad_plain(tb_[i:i + chunk], Xc, yc, weights,
                                        opsc, scale=True)
                for i in range(0, tb_.length.shape[0], chunk)]
        lp, gp, okp, scale = (torch.cat(z) for z in zip(*outs))
        if mirror:
            outs = [kg.eval_loss_grad_program_plain(tb_[i:i + chunk], Xc, yc,
                                                    weights, opsc)
                    for i in range(0, tb_.length.shape[0], chunk)]
            lm, gm, okm = (torch.cat(z) for z in zip(*outs))
            assert torch.equal(okk, okm), "gradient vs mirror: ok differs"
            assert_bits("gradient vs mirror, loss", lk[okk], lm[okk])
            assert_bits("gradient vs mirror, gradient", gk[okk], gm[okk])
        check_losses("loss_grad", lk, okk, lp, okp, min_poisoned)
        gk, gp, scale = gk[okp], gp[okp], scale[okp]
        nan_term = torch.isnan(scale)
        assert bool(torch.isnan(gk[nan_term]).all()), "gradient NaN differs"
        assert bool(torch.isnan(gp[nan_term]).all()), "plain gradient NaN differs"
        fin = torch.isfinite(scale)
        assert bool(torch.isfinite(gk[fin]).all()), "gradient overflowed"
        excess = ((gk - gp).abs() - 1e-4 * gp.abs()) / scale.clamp_min(1e-30)
        worst = float(excess[fin].max()) if bool(fin.any()) else 0.0
        beyond = (excess > 1e-5) & fin
        assert not bool(beyond.any()), (
            f"{int(beyond.sum())} gradients differ; worst excess {worst:.3g} "
            "of the row-sum yardstick")
        note("loss_grad", gk[fin], gp[fin])
        compared = fin & (gp != 0)
        return (int(okk.sum()), int(compared.sum()),
                int((compared & (gk == gp)).sum()),
                int((~fin & ~nan_term).sum()), worst)

    def check_loss(weights, chunk=16384, tb_=opt_trees, cv=ls_cval, Xc=X,
                   yc=y, opsc=ops, min_poisoned=4):
        fn = kg.make_loss_kernel(tb_, Xc, yc, weights, opsc,
                                 with_grad=False, reps=LS_STEPS)
        lk, _, okk = fn(cv)
        lk2, _, okk2 = fn(cv)
        assert torch.equal(okk, okk2), "loss-only: two launches, ok differs"
        assert_bits("loss-only: two launches", lk2, lk)
        rep = tb_.map(lambda f: f.repeat_interleave(LS_STEPS, 0))._replace(
            cval=cv.reshape(-1, cv.shape[-1]))
        outs = [kg.eval_loss_plain(rep[i:i + chunk], Xc, yc, weights, opsc)
                for i in range(0, rep.length.shape[0], chunk)]
        lp, okp = (torch.cat(z) for z in zip(*outs))
        check_losses("loss", lk, okk, lp, okp, min_poisoned)

    for weights, label in ((None, "unweighted"), (w_zero, "weighted, 64 zero-weight rows")):
        n_ok, n_grad, n_equal, n_over, worst = check_grad(weights, mirror=True)
        check_loss(weights)
        torch.cuda.synchronize()
        log(f"constant-opt kernel vs plain ({label}): agree at {T_OPT} instances "
            f"(gradient; {n_ok} not poisoned, {n_grad} non-zero CONST "
            f"gradients compared, {n_equal} of them bit-equal, worst excess "
            f"{worst:.3g} of the row-sum "
            f"yardstick, {n_over} whose row sum overflows; bit-equal to the "
            f"plain mirror, over two launches and to the loss-only kernel's "
            f"loss) and {T_OPT * LS_STEPS} (loss only) x {ROWS} rows")
    # programs of up to 109 slots at max_len 128 (a search at maxsize 110
    # or more), which the gradient kernel of earlier versions refused
    L_LONG, T_LONG = 128, 4096
    long_trees = random_trees(gen, torch.randint(3, 110, (T_LONG,), generator=gen, device=dev), 1,
        ops, L_LONG, dev)
    long_trees = TreeBatch(*(torch.cat([a[: T_LONG - 4], b]) for a, b in zip(
        long_trees, stack_trees([encode_tree(e, L_LONG, device=dev)
                                 for e in poison]))))
    long_cval = long_trees.cval.repeat_interleave(LS_STEPS, 0) * (
        1 + 0.1 * torch.randn((T_LONG * LS_STEPS, L_LONG), generator=gen,
                              device=dev))
    n_ok, n_grad, n_equal, n_over, worst = check_grad(
        w_zero, chunk=512, tb_=long_trees, mirror=True)
    check_loss(w_zero, chunk=2048, tb_=long_trees, cv=long_cval)
    torch.cuda.synchronize()
    log(f"constant-opt kernel vs plain at max_len {L_LONG} (weighted): agree "
        f"at {T_LONG} instances (gradient; {n_ok} not poisoned, {n_grad} "
        f"non-zero CONST gradients compared, {n_equal} bit-equal, worst "
        f"excess {worst:.3g}, {n_over} whose row sum overflows; bit-equal to "
        f"the plain mirror) and {T_LONG * LS_STEPS} (loss only); layout "
        f"{kg.grad_plan(T_LONG, 1, L_LONG, False)}")
    log(f"constant-opt kernel: max abs err loss_grad {err['loss_grad']:.3g}, "
        f"loss {err['loss']:.3g}; max rel err loss_grad {rel['loss_grad']:.3g}, "
        f"loss {rel['loss']:.3g}")

    # ---- 3b. every kernel on all 44 registry operators ----------------------
    # the registries' own 44 (phase 1 registered the user pair beside them)
    all_ops = make_operator_set(
        sorted(n for n in BINARY_REGISTRY
               if n != "pow" and not is_user_operator(2, n)),
        sorted(n for n in UNARY_REGISTRY if not is_user_operator(1, n)))
    T_GRID = 4096
    ggen = synthetic_generator(3, dev)
    g_trees = random_trees(ggen, torch.randint(1, 21, (T_GRID,), generator=ggen, device=dev), 3,
        all_ops, 24, dev)
    Xg = torch.randn((3, ROWS), generator=ggen, device=dev) * 1.5
    yg = torch.randn(ROWS, generator=ggen, device=dev)
    grid_err = dict.fromkeys(("value", "fused", "slots", "fold", "loss_grad",
                              "loss",
                              "instr", "instr_packed"), 0.0)
    saved = dict(err), dict(rel)
    for k in grid_err:
        err[k] = rel[k] = 0.0
    yk, okk = ke.eval_trees(g_trees, Xg, all_ops)
    yp, okp = ke.eval_trees_plain(g_trees, Xg, all_ops)
    assert torch.equal(okk, okp), "44 operators, value mode: ok differs"
    torch.testing.assert_close(yk[okk], yp[okk], rtol=1e-5, atol=1e-6)
    note("value", yk[okk], yp[okk])
    lk = ke.eval_loss_trees(g_trees, Xg, yg, all_ops)
    lp = ke.eval_loss_trees_plain(g_trees, Xg, yg, all_ops)
    assert torch.equal(torch.isinf(lk), torch.isinf(lp)), "44 operators: inf differs"
    fin = torch.isfinite(lp)
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-4, atol=0)
    note("fused", lk[fin], lp[fin])
    sk, _ = ke.eval_slot_values(g_trees, Xg[:, :1], all_ops)
    sp, _ = ke.eval_slot_values_plain(g_trees, Xg[:, :1], all_ops)
    fin = torch.isfinite(sp)
    assert torch.equal(torch.isfinite(sk), fin), "44 operators, slots: finite set"
    torch.testing.assert_close(sk[fin], sp[fin], rtol=1e-5, atol=1e-6)
    note("slots", sk[fin], sp[fin])
    n_grid_fold = check_fold(constant_heavy(g_trees, ggen), all_ops,
                             "44 operators", exact=False)
    n_grid_ok = check_instr(g_trees, Xg, all_ops, "44 operators")
    g_cval = g_trees.cval.repeat_interleave(LS_STEPS, 0) * (
        1 + 0.1 * torch.randn((T_GRID * LS_STEPS, 24), generator=ggen,
                              device=dev))
    _, n_grad, n_equal, n_over, worst = check_grad(
        None, tb_=g_trees, Xc=Xg, yc=yg, opsc=all_ops, min_poisoned=1)
    check_loss(None, tb_=g_trees, cv=g_cval, Xc=Xg, yc=yg, opsc=all_ops,
               min_poisoned=1)
    xd = torch.cat([torch.linspace(-9.75, 40, 8000, device=dev),
                    torch.tensor([0.0, -0.0, 1e-30, 1e6, 3e38, float("inf"),
                                  -float("inf"), float("nan"), 1.4616321],
                                 device=dev)])
    dk, dr = kg.digamma_on_card(xd), torch.digamma(xd)
    assert torch.equal(torch.isnan(dk), torch.isnan(dr)), "digamma: NaN differs"
    assert torch.equal(torch.isinf(dk), torch.isinf(dr)), "digamma: inf differs"
    fin = torch.isfinite(dr)
    # atol: torch's float32 digamma subtracts up to ten terms below 3, half
    # an ulp (1.2e-7) each, so near a root only absolute digits are kept
    torch.testing.assert_close(dk[fin], dr[fin], rtol=1e-5, atol=2e-6)
    digamma_err = float((dk[fin] - dr[fin]).abs().max())
    for k in grid_err:
        grid_err[k] = err[k]
    err.update(saved[0])
    rel.update(saved[1])
    torch.cuda.synchronize()
    log(f"44 operators: {T_GRID} random trees x {ROWS} rows through every "
        f"kernel agree with the plain versions ({n_grid_ok} not poisoned; "
        f"B5/B6 bit-equal to the value mode; {n_grad} non-zero CONST "
        f"gradients compared, {n_equal} bit-equal, worst excess {worst:.3g} "
        f"of the row-sum yardstick, {n_over} whose row sum overflows; the "
        f"fold changed {n_grid_fold} constant-heavy trees, its structure "
        f"exact); max abs err {grid_err}; digamma vs torch.digamma max abs err "
        f"{digamma_err:.3g}")
    rng_s = np.random.default_rng(1)
    Xs = rng_s.uniform(-1.5, 1.5, (2, 400)).astype(np.float32)
    ys = (np.arcsin(Xs[0] * 0.5) + np.arctan2(Xs[1], 1.5)).astype(np.float32)
    tr = time.time()
    before_opt = dict(kg.LAUNCHES)
    res_s = equation_search(Xs, ys, binary_operators=["+", "*", "mod", "atan2"],
                            unary_operators=["asin", "erf", "gamma"],
                            npopulations=8, npop=60, ncycles_per_iteration=30,
                            maxsize=12, niterations=2, seed=0, verbosity=0)
    assert res_s.frontier() and np.isfinite(res_s.best_loss().loss)
    assert kg.LAUNCHES["loss_grad"] - before_opt["loss_grad"] == 9 * 2
    log(f"search over asin erf gamma mod atan2 (8 x 60, 2 iterations, default "
        f"constant optimisation): best {res_s.best_loss().equation} loss "
        f"{res_s.best_loss().loss:.3g}, {time.time() - tr:.1f} s")
    # maxsize 110: max_len 112, above the 104 that the gradient kernel of
    # earlier versions took
    tr = time.time()
    before_opt = dict(kg.LAUNCHES)
    res_l = equation_search(Xs, ys, binary_operators=["+", "-", "*", "/"],
                            unary_operators=["cos", "exp"], npopulations=8,
                            npop=60, ncycles_per_iteration=30, maxsize=110,
                            niterations=2, seed=0, verbosity=0)
    assert res_l.options.max_len == 112, res_l.options.max_len
    assert res_l.frontier() and np.isfinite(res_l.best_loss().loss)
    assert kg.LAUNCHES["loss_grad"] - before_opt["loss_grad"] == 9 * 2
    assert kg.LAUNCHES["loss"] - before_opt["loss"] == 8 * 2
    log(f"search at maxsize 110 (max_len 112; 8 x 60, 2 iterations, default "
        f"constant optimisation): best {res_l.best_loss().equation} loss "
        f"{res_l.best_loss().loss:.3g}, {time.time() - tr:.1f} s")

    # ---- 3c. every kernel at max_len 512, 1,024 and 2,048 --------------------
    def deep_programs(max_len):
        """x0 c x0 c ... (k leaves) then k - 1 slots of + and -, a stack of
        k = min(300, (max_len + 1) // 2 - 1) entries; and a chain of
        max_len - 1 cos."""
        k = min(300, (max_len + 1) // 2 - 1)
        kind = torch.zeros((2, max_len), dtype=torch.int64, device=dev)
        op = torch.zeros_like(kind)
        cval = torch.zeros((2, max_len), device=dev)
        i = torch.arange(k, device=dev)
        kind[0, :k] = torch.where(i % 2 == 0, VAR, CONST)
        cval[0, :k] = torch.where(i % 2 == 0, 0.0, 0.25 + 0.001 * i)
        kind[0, k:2 * k - 1] = BIN
        op[0, k:2 * k - 1] = torch.arange(k - 1, device=dev) % 2
        kind[1, 0], kind[1, 1:] = VAR, UNA
        return TreeBatch(kind, op, torch.zeros_like(kind), cval,
                         torch.tensor([2 * k - 1, max_len], device=dev))

    long_report = {}
    for L_big, T_big in ((512, 600), (1024, 200), (2048, 60)):
        tl = time.time()
        big = random_trees(gen, torch.randint(1, L_big - 2, (T_big,), generator=gen,
                               device=dev), 1, ops, L_big, dev)
        kind_b = torch.zeros((len(shapes_), L_big), dtype=torch.int64,
                             device=dev)
        kind_b[:, :24] = kind_
        bad_b = TreeBatch(kind_b, torch.nn.functional.pad(op_, (0, L_big - 24)),
                          torch.nn.functional.pad(feat_, (0, L_big - 24)),
                          torch.full(kind_b.shape, 0.5, device=dev),
                          invalid.length.clone())
        bad_b.length[3] = L_big + 1  # a length beyond max_len
        big = TreeBatch(*(torch.cat(z) for z in zip(
            big, deep_programs(L_big),
            stack_trees([encode_tree(e, L_big, device=dev) for e in poison]),
            bad_b)))
        nb = len(shapes_)
        assert bool(ke.runnable(bad_b, ops, X.shape[0])[1].all())
        yk, okk = ke.eval_trees(big, X, ops)
        assert_bits(f"max_len {L_big}, value mode: two launches",
                    ke.eval_trees(big, X, ops)[0], yk)
        y_stack, bad_s = ke.eval_program_plain(big, X, ops)
        assert torch.equal(okk, ~bad_s & (big.length > 0)), L_big
        assert int((~okk[:-nb]).sum()) >= 4 and not okk[-nb:].any(), L_big
        assert_bits(f"max_len {L_big}, value mode vs plain", yk[okk],
                    y_stack[okk])
        assert not yk[-nb:].any()
        lk = ke.eval_loss_trees(big, X, y, ops)
        assert_bits(f"max_len {L_big}, fused: two launches",
                    ke.eval_loss_trees(big, X, y, ops), lk)
        lp = ke.eval_loss_trees_plain(big, X, y, ops)
        assert torch.equal(torch.isinf(lk), torch.isinf(lp)), L_big
        assert bool(lk[-nb:].isposinf().all())
        fin = torch.isfinite(lp)
        torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-4, atol=0)
        sk, oks = ke.eval_slot_values(big, X1, ops)
        sp, _ = ke.eval_slot_values_plain(big, X1, ops)
        fin = torch.isfinite(sp)
        assert torch.equal(torch.isfinite(sk), fin) and not oks[-nb:].any()
        assert_bits(f"max_len {L_big}, slot values vs plain", sk[fin], sp[fin])
        # the fold: its arenas in shared memory at 512, in global memory
        # above; the invalid programs left as they were
        chunk = max(8, (1 << 28) // L_big ** 2)
        check_fold(big, ops, f"max_len {L_big}", chunk=chunk)
        assert check_fold(constant_heavy(big, gen), ops,
                          f"max_len {L_big}, constant-heavy",
                          chunk=chunk) > T_big // 2
        assert not ke.fold_trees(big, ops)[1][-nb:].any()
        lg, gg, okg = kg.eval_loss_grad(big, X, y, w_zero, ops)
        lg2, gg2, _ = kg.eval_loss_grad(big, X, y, w_zero, ops)
        assert_bits(f"max_len {L_big}, gradient: two launches", gg2, gg)
        assert_bits(f"max_len {L_big}, gradient loss: two launches", lg2, lg)
        lm, gm, okm = kg.eval_loss_grad_program_plain(big, X, y, w_zero, ops)
        assert torch.equal(okg, okm) and not okg[-nb:].any(), L_big
        assert_bits(f"max_len {L_big}, gradient vs mirror, loss", lg[okg], lm[okg])
        assert_bits(f"max_len {L_big}, gradient vs mirror", gg[okg], gm[okg])
        assert not gg[-nb:].any()
        for reps in (1, LS_STEPS):
            fn = kg.make_loss_kernel(big, X, y, w_zero, ops, with_grad=False,
                                     reps=reps)
            l4, _, ok4 = fn(big.cval.repeat_interleave(reps, 0))
            assert torch.equal(ok4.reshape(-1, reps),
                               okg.unsqueeze(-1).expand(-1, reps)), reps
            assert_bits(f"max_len {L_big}, gradient vs loss-only (reps {reps})",
                        l4.reshape(-1, reps),
                        lg.unsqueeze(-1).expand(-1, reps).contiguous())
        instr_checked = []
        for name, packed in (("instr", False), ("instr_packed", True)):
            if packed and X.shape[0] + L_big + 4 > 2048:
                continue
            yi, oki = ki.eval_trees_instr(big, X, ops, packed)
            assert torch.equal(oki, okk), (name, L_big)
            assert_bits(f"max_len {L_big}, {name} vs value mode", yi[okk], yk[okk])
            instr_checked.append(name)
        torch.cuda.synchronize()
        T_all = big.length.shape[0]
        fold_layout = ke.fold_launch_plan(T_all, L_big, torch.float32, None, 0)
        layouts = dict(
            value=ke.launch_plan(T_all, L_big, 1, ROWS, ke.MODE_VALUE, False, 0),
            loss_grad=kg.grad_plan(T_all, 1, L_big, False),
            loss=kg.loss_plan(T_all, LS_STEPS, L_big, False),
            instr=ki.launch_plan(T_all, L_big, 1, ROWS, False, False, 0))
        long_report[L_big] = {k: v._asdict() for k, v in layouts.items()}
        long_report[L_big]["fold"] = fold_layout._asdict()
        log(f"max_len {L_big}: {T_all} trees ({int(okk.sum())} not poisoned, "
            f"{nb} invalid) x {ROWS} rows: value mode, slot values and the "
            f"fold (arenas {'in global memory' if fold_layout.scratch_bytes else 'in shared memory'}, "
            f"{fold_layout.blocks} blocks) bit-equal to "
            f"the plain versions, fused within rtol 1e-4, gradient bit-equal "
            f"to its mirror and its loss to the loss-only kernel's, "
            f"{' and '.join(instr_checked)} bit-equal to the value mode, two "
            f"launches the same bits; {time.time() - tl:.1f} s; layouts "
            + "; ".join(f"{k} {'narrow' if v.narrow else 'wide'} {v.warps} "
                        f"warps/block {v.blocks_per_sm} blocks/SM "
                        f"scratch {v.scratch_bytes} B"
                        for k, v in layouts.items()))
    # maxsize 509: max_len 512, which every kernel of earlier versions refused
    tr = time.time()
    before_all = {**ke.LAUNCHES, **kg.LAUNCHES}
    res_509 = equation_search(Xs, ys, binary_operators=["+", "-", "*", "/"],
                              unary_operators=["cos", "exp"], npopulations=8,
                              npop=60, ncycles_per_iteration=30, maxsize=509,
                              niterations=2, seed=0, verbosity=0)
    after_all = {**ke.LAUNCHES, **kg.LAUNCHES}
    assert res_509.options.max_len == 512, res_509.options.max_len
    assert res_509.frontier() and np.isfinite(res_509.best_loss().loss)
    assert after_all["loss_grad"] - before_all["loss_grad"] == 9 * 2
    assert after_all["loss"] - before_all["loss"] == 8 * 2
    assert after_all["fused"] - before_all["fused"] >= 2 * 30
    assert after_all["fold"] - before_all["fold"] >= 2 * 30
    long_report["search_509"] = dict(
        s=time.time() - tr, best=res_509.best_loss().loss,
        max_len=res_509.options.max_len,
        launches={k: after_all[k] - before_all[k] for k in after_all})
    log(f"search at maxsize 509 (max_len 512; 8 x 60, 2 iterations, default "
        f"constant optimisation): best {res_509.best_loss().equation} loss "
        f"{res_509.best_loss().loss:.3g}, launches "
        f"{long_report['search_509']['launches']}, {time.time() - tr:.1f} s")

    # ---- 3d. every loss at the main path's shapes -----------------------------
    tloss = time.time()
    every_loss = list(dict.fromkeys(tlosses.LOSS_REGISTRY.values()))
    # the stack machine's roots, once (the loss comes after the last slot)
    outs = [ke.eval_program_plain(ke._flatten(trees[i:i + 8192]), X, ops)
            for i in range(0, T_RESCORE, 8192)]
    root_all = torch.cat([o[0] for o in outs])
    ok_all = ~torch.cat([o[1] for o in outs]) & (trees.length > 0)
    del outs
    opt_sub = opt_trees[:4096]
    loss_err = {}

    def max_err(got, ref):
        return float((got - ref).abs().max()) if got.numel() else 0.0

    for loss in every_loss:
        exact = loss.kind not in tlosses.TRANSCENDENTAL
        any_loss = loss.kind != tlosses.L2
        le = loss_err[loss.name] = {}
        for tb_, root_, ok_ in ((cycle, root_all[-T_CYCLE:], ok_all[-T_CYCLE:]),
                                (trees, root_all, ok_all)):
            T = tb_.length.shape[0]
            lk = ke.eval_loss_trees(tb_, X, y, ops, loss)
            assert_bits(f"{loss.name}, fused: two launches",
                        ke.eval_loss_trees(tb_, X, y, ops, loss), lk)
            plan = ke.launch_plan(T, 24, X.shape[0], ROWS, ke.MODE_FUSED,
                                  False, 0, any_loss)
            lm = tlosses.contain_nonfinite(
                ke.fused_sums_plain(root_, y, loss, plan) / ROWS, ok_)
            assert torch.equal(torch.isinf(lk), torch.isinf(lm)), loss.name
            fin = torch.isfinite(lm)
            if exact and any_loss:
                assert_bits(f"{loss.name}, fused vs mirror", lk[fin], lm[fin])
            else:
                torch.testing.assert_close(lk[fin], lm[fin], atol=0,
                                           rtol=1e-5 if any_loss else 1e-6)
            le[f"fused@{T}"] = max_err(lk[fin], lm[fin])
        fn3 = kg.make_loss_kernel(opt_trees, X, y, None, ops, True, loss=loss)
        l3, g3, ok3 = fn3(opt_trees.cval)
        l3b, g3b, _ = fn3(opt_trees.cval)
        assert_bits(f"{loss.name}, gradient: two launches, loss", l3b, l3)
        assert_bits(f"{loss.name}, gradient: two launches", g3b, g3)
        fn4 = kg.make_loss_kernel(opt_trees, X, y, None, ops, False, LS_STEPS,
                                  loss=loss)
        l4, _, ok4 = fn4(opt_trees.cval.repeat_interleave(LS_STEPS, 0))
        assert torch.equal(ok4.reshape(-1, LS_STEPS),
                           ok3.unsqueeze(-1).expand(-1, LS_STEPS))
        assert_bits(f"{loss.name}, gradient vs loss-only kernel",
                    l4.reshape(-1, LS_STEPS),
                    l3.unsqueeze(-1).expand(-1, LS_STEPS).contiguous())
        assert_bits(f"{loss.name}, loss-only: two launches", fn4(ls_cval)[0],
                    fn4(ls_cval)[0])
        lm, gm, okm = kg.eval_loss_grad_program_plain(opt_sub, X, y, None, ops,
                                                      loss=loss)
        n = 4096
        assert torch.equal(ok3[:n], okm), loss.name
        k3, kg3, km, kgm = l3[:n][okm], g3[:n][okm], lm[okm], gm[okm]
        if exact:
            assert_bits(f"{loss.name}, gradient vs mirror, loss", k3, km)
            assert_bits(f"{loss.name}, gradient vs mirror", kg3, kgm)
        else:
            fin = torch.isfinite(km)
            assert torch.equal(torch.isfinite(k3), fin), loss.name
            torch.testing.assert_close(k3[fin], km[fin], rtol=1e-5, atol=0)
            scale = kg.eval_loss_grad_plain(opt_sub, X, y, None, ops,
                                            scale=True, loss=loss)[3][okm]
            m = torch.isfinite(scale)
            assert bool(torch.isnan(kg3[torch.isnan(scale)]).all()), loss.name
            tol = 1e-4 * kgm.abs() + 1e-5 * scale
            assert bool(((kg3 - kgm).abs() <= tol)[m].all()), loss.name
        fin = torch.isfinite(km)
        le["loss_grad"] = max_err(k3[fin], km[fin])
        both = torch.isfinite(kg3) & torch.isfinite(kgm)
        le["gradient"] = max_err(kg3[both], kgm[both])
    del root_all, ok_all, root_, ok_  # 0.5 GB that the main path's peak reads
    n_exact = sum(x.kind not in tlosses.TRANSCENDENTAL for x in every_loss)
    torch.cuda.synchronize()
    log(f"every loss ({len(every_loss)}): B2 at {T_CYCLE} and {T_RESCORE} "
        f"trees, B3 at {T_OPT} and B4 at {T_OPT * LS_STEPS} instances x "
        f"{ROWS} rows: two launches the same bits, B3's loss B4's in every "
        f"bit, against the mirrors bit for bit without a transcendental "
        f"function ({n_exact} losses; L2's B2 within rtol 1e-6), the rest "
        f"within rtol 1e-5; "
        f"{time.time() - tloss:.1f} s; max abs err against the mirrors "
        f"{loss_err}")

    # ---- 3e. the bfloat16 and float16 builds ------------------------------------
    tstore = time.time()

    def bits(t):
        """The bit patterns of 2-, 4- or 8-byte floats."""
        return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])

    store_err = {}  # max abs err of each storage build against its plain version

    def assert_same(name, got, ref, kernel=None):
        """``got`` and ``ref`` bit-equal; with ``kernel`` (a record name,
        ``value_bf16``, ...) ``ref`` is that build's plain version, and the
        largest difference over the finite values goes to its record."""
        assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
        n = int((bits(got) != bits(ref)).sum())
        assert n == 0, f"{name}: {n} values differ"
        if kernel is not None:
            fin = torch.isfinite(ref)
            d = (got[fin].double() - ref[fin].double()).abs()
            store_err[kernel] = max(store_err.get(kernel, 0.0),
                                    float(d.max()) if d.numel() else 0.0)

    # programs whose value overflows only at the storage rounding: 143/128 x
    # 229 * 2^120 = 3.4006e38 (finite in float32, inf in bfloat16) and
    # exp(11.2) = 73,130 (inf in float16); the invalid programs of phase 2
    over = stack_trees([encode_tree(parse_expression(e, ops), 24, device=dev)
                        for e in ("(x0 * 0.0 + 1.1171875) * "
                                  f"{229 * 2.0 ** 120!r}",
                                  "exp(x0 * 0.0 + 11.2)")])
    front = TreeBatch(*(torch.cat(z) for z in zip(over, invalid)))
    nf = front.length.shape[0]
    head = lambda tb_: TreeBatch(*(torch.cat([a, b[nf:]])
                                   for a, b in zip(front, tb_)))
    cycle_s, trees_s = head(cycle), head(trees)
    opt_s = trees_s[:T_OPT]
    storage_report = {}
    # ---- 3g. the float64 builds: the same checks after the 2-byte ones ------
    for dt in ke.OTHER_STORAGE:
        sfx = ke.STORAGE[dt][1]
        rep = storage_report[sfx[1:]] = {}
        Xs, ys, X1s = X.to(dt), y.to(dt), X1.to(dt)
        t_dt = time.time()
        # the overflow at the rounding poisons at this dtype alone (at
        # float64 neither program overflows)
        ok32 = ke.eval_trees(over, X, ops)[1]
        okst = ke.eval_trees(over, Xs, ops)[1]
        if dt == torch.float64:
            assert bool(ok32.all()) and bool(okst.all())
        else:
            assert bool(ok32.all()) and not bool(okst[0 if sfx == "_bf16"
                                                      else 1])
        for tb_ in (cycle_s, trees_s):
            T = tb_.length.shape[0]
            yk, okk = ke.eval_trees(tb_, Xs, ops)
            assert yk.dtype == dt
            assert_same(f"value{sfx} T={T}: two launches",
                        ke.eval_trees(tb_, Xs, ops)[0], yk)
            outs = [ke.eval_trees_plain(tb_[i:i + 8192], Xs, ops)
                    for i in range(0, T, 8192)]
            yp, okp = (torch.cat(z) for z in zip(*outs))
            assert torch.equal(okk, okp), f"value{sfx}: ok differs"
            assert not okk[2:nf].any() and not yk[2:nf].any()
            assert int((~okk).sum()) >= nf + (2 if dt == torch.float64 else 3), (
                "poisoning trees were not poisoned")
            assert_same(f"value{sfx} T={T} vs plain", yk[okk], yp[okk],
                        "value" + sfx)
            sk, oks = ke.eval_slot_values(tb_, X1s, ops)
            assert_same(f"slots{sfx} T={T}: two launches",
                        ke.eval_slot_values(tb_, X1s, ops)[0], sk)
            sp, okps = ke.eval_slot_values_plain(tb_, X1s, ops)
            fin = torch.isfinite(sp)
            assert torch.equal(torch.isfinite(sk), fin) and torch.equal(oks, okps)
            assert_same(f"slots{sfx} T={T} vs plain", sk[fin], sp[fin],
                        "slots" + sfx)
            tb_dt = tb_._replace(cval=tb_.cval.to(dt))
            check_fold(tb_dt, ops, f"{sfx[1:]}@{T}")
            assert check_fold(constant_heavy(tb_dt, gen), ops,
                              f"{sfx[1:]}, constant-heavy@{T}") > T // 2
            store_err["fold" + sfx] = 0.0  # every bit equal (check_fold)
            for name, packed in (("instr", False), ("instr_packed", True)):
                yi, oki = ki.eval_trees_instr(tb_, Xs, ops, packed)
                assert torch.equal(oki, okk), f"{name}{sfx}: ok differs from B1"
                assert_same(f"{name}{sfx} T={T} vs B1", yi[okk], yk[okk])
                assert_same(f"{name}{sfx} T={T}: two launches",
                            ki.eval_trees_instr(tb_, Xs, ops, packed)[0], yi)
                outs = [ki.eval_trees_instr_plain(tb_[i:i + 8192], Xs, ops,
                                                  packed)
                        for i in range(0, T, 8192)]
                yip, okip = (torch.cat(z) for z in zip(*outs))
                assert torch.equal(okip, oki)
                assert_same(f"{name}{sfx} T={T} vs plain", yi[oki], yip[oki],
                            name + sfx)
            rep[f"trees@{T}"] = dict(not_poisoned=int(okk.sum()))
        for weights in (None, w_zero):
            raw3 = kg.stage_launch(opt_s, Xs, ys, weights, ops, True, 1)
            l3, g3, b3 = raw3(opt_s.cval)
            l3b, g3b, b3b = raw3(opt_s.cval)
            assert_same(f"loss_grad{sfx}: two launches, loss", l3b, l3)
            assert_same(f"loss_grad{sfx}: two launches", g3b, g3)
            assert torch.equal(b3, b3b)
            ok3 = (b3 == 0) & (opt_s.length > 0)
            lm, gm, okm = kg.eval_loss_grad_program_plain(opt_s[:4096], Xs, ys,
                                                          weights, ops)
            assert torch.equal(ok3[:4096], okm), f"loss_grad{sfx}: ok vs mirror"
            assert_same(f"loss_grad{sfx} vs mirror, loss", l3[:4096][okm],
                        lm[okm], "loss_grad" + sfx)
            assert_same(f"loss_grad{sfx} vs mirror", g3[:4096][okm], gm[okm],
                        "loss_grad" + sfx)
            for reps in (1, LS_STEPS):
                raw4 = kg.stage_launch(opt_s, Xs, ys, weights, ops, False, reps)
                l4, _, b4 = raw4(opt_s.cval.repeat_interleave(reps, 0))
                assert torch.equal(b4.reshape(-1, reps),
                                   b3.unsqueeze(-1).expand(-1, reps))
                assert_same(f"loss{sfx} (reps {reps}) vs loss_grad{sfx}",
                            l4.reshape(-1, reps),
                            l3.unsqueeze(-1).expand(-1, reps).contiguous())
            # the line search's input: 8 different constant vectors per
            # tree, held against the mirror (B3's operations, whose loss is
            # B4's in every bit) on the first 512 trees' 4,096 instances
            raw4 = kg.stage_launch(opt_s, Xs, ys, weights, ops, False, LS_STEPS)
            l4, _, b4 = raw4(ls_cval)
            assert_same(f"loss{sfx}: two launches", raw4(ls_cval)[0], l4)
            n4 = 4096
            cand = opt_s[:n4 // LS_STEPS].map(
                lambda f: f.repeat_interleave(LS_STEPS, 0))._replace(
                    cval=ls_cval[:n4])
            lm, _, okm = kg.eval_loss_grad_program_plain(cand, Xs, ys, weights,
                                                         ops)
            assert torch.equal((b4[:n4] == 0) & (cand.length > 0), okm), (
                f"loss{sfx}: ok vs mirror on the line search's candidates")
            assert_same(f"loss{sfx} vs mirror, line-search candidates",
                        l4[:n4][okm], lm[okm], "loss" + sfx)
            rep[f"opt@{'weighted' if weights is not None else 'unweighted'}"] = (
                dict(not_poisoned=int(ok3.sum())))
        # the long programs: narrow routes at 1,024
        for L_big, T_big in ((512, 600), (1024, 200)):
            big = random_trees(gen, torch.randint(1, L_big - 2, (T_big,), generator=gen,
                                   device=dev), 1, ops, L_big, dev)
            big = TreeBatch(*(torch.cat(z) for z in zip(
                big, deep_programs(L_big),
                stack_trees([encode_tree(e, L_big, device=dev)
                             for e in poison]))))
            yk, okk = ke.eval_trees(big, Xs, ops)
            assert_same(f"max_len {L_big}, value{sfx}: two launches",
                        ke.eval_trees(big, Xs, ops)[0], yk)
            ym, bad_m = ke.eval_program_plain(big, Xs, ops)
            assert torch.equal(okk, ~bad_m & (big.length > 0)), L_big
            assert_same(f"max_len {L_big}, value{sfx} vs plain", yk[okk],
                        ym[okk], "value" + sfx)
            sk, _ = ke.eval_slot_values(big, X1s, ops)
            sp, _ = ke.eval_slot_values_plain(big, X1s, ops)
            fin = torch.isfinite(sp)
            assert torch.equal(torch.isfinite(sk), fin), L_big
            assert_same(f"max_len {L_big}, slots{sfx} vs plain", sk[fin],
                        sp[fin], "slots" + sfx)
            big_dt = constant_heavy(big._replace(cval=big.cval.to(dt)), gen)
            assert check_fold(big_dt, ops, f"max_len {L_big}, {sfx[1:]}",
                              chunk=(1 << 28) // L_big ** 2) > T_big // 2
            for name, packed in (("instr", False), ("instr_packed", True)):
                yi, oki = ki.eval_trees_instr(big, Xs, ops, packed)
                assert torch.equal(oki, okk), (name, L_big)
                assert_same(f"max_len {L_big}, {name}{sfx} vs B1", yi[okk], yk[okk])
            raw3 = kg.stage_launch(big, Xs, ys, w_zero, ops, True, 1)
            l3, g3, b3 = raw3(big.cval)
            assert_same(f"max_len {L_big}, loss_grad{sfx}: two launches",
                        raw3(big.cval)[1], g3)
            lm, gm, okm = kg.eval_loss_grad_program_plain(big, Xs, ys, w_zero,
                                                          ops)
            ok3 = (b3 == 0) & (big.length > 0)
            assert torch.equal(ok3, okm), L_big
            assert_same(f"max_len {L_big}, loss_grad{sfx} vs mirror, loss",
                        l3[okm], lm[okm], "loss_grad" + sfx)
            assert_same(f"max_len {L_big}, loss_grad{sfx} vs mirror",
                        g3[okm], gm[okm], "loss_grad" + sfx)
            for reps in (1, LS_STEPS):
                raw4 = kg.stage_launch(big, Xs, ys, w_zero, ops, False, reps)
                l4 = raw4(big.cval.repeat_interleave(reps, 0))[0]
                assert_same(f"max_len {L_big}, loss{sfx} (reps {reps}) vs "
                            f"loss_grad{sfx}", l4.reshape(-1, reps),
                            l3.unsqueeze(-1).expand(-1, reps).contiguous())
            # 8 different constant vectors per tree, the first 32 trees'
            # candidates against the mirror
            big_cv = big.cval.repeat_interleave(LS_STEPS, 0) * (1 + 0.1 * torch.randn(
                (big.cval.shape[0] * LS_STEPS, L_big), generator=gen, device=dev))
            l4, _, b4 = raw4(big_cv)
            n4 = 32 * LS_STEPS
            cand = big[:32].map(lambda f: f.repeat_interleave(LS_STEPS, 0)
                                )._replace(cval=big_cv[:n4])
            lm, _, okm = kg.eval_loss_grad_program_plain(cand, Xs, ys, w_zero,
                                                         ops)
            assert torch.equal((b4[:n4] == 0) & (cand.length > 0), okm), L_big
            assert_same(f"max_len {L_big}, loss{sfx} vs mirror, line-search "
                        f"candidates", l4[:n4][okm], lm[okm], "loss" + sfx)
            T_all = big.length.shape[0]
            rep[f"max_len {L_big}"] = dict(
                not_poisoned=int(okk.sum()),
                value=ke.launch_plan(T_all, L_big, 1, ROWS, ke.MODE_VALUE,
                                     False, 0, False, dt).narrow,
                loss_grad=kg.grad_plan(T_all, 1, L_big, False, False, dt).narrow,
                loss=kg.loss_plan(T_all, LS_STEPS, L_big, False, False, dt).narrow,
                instr=ki.launch_plan(T_all, L_big, 1, ROWS, False, False, 0,
                                     dt).narrow)
        torch.cuda.synchronize()
        rep["seconds"] = time.time() - t_dt
        log(f"{'3g' if dt == torch.float64 else '3e'} storage {sfx[1:]}: "
            f"B1, the slot values, the fold, B5, B6 at {T_CYCLE} and "
            f"{T_RESCORE} trees, B3 at {T_OPT} and B4 at {T_OPT} x 1 / "
            f"{T_OPT * LS_STEPS} instances x {ROWS} rows (unweighted and "
            f"weighted), every kernel at max_len 512 and 1,024: bit-equal to "
            f"the plain versions (B4 on the line search's distinct candidates "
            f"too), B5/B6 to B1, B3's loss to B4's, two "
            f"launches the same bits, overflow at the rounding and invalid "
            f"programs poisoned; {rep}")
    log(f"storage builds checked in {time.time() - tstore:.1f} s")

    # ---- 3g. the cotangent-seeded mode of B3 (f32 and f64) ---------------------
    # the VJP of B1's value with respect to the constants for a seed g per
    # instance and row: bit-equal to its plain mirror on 4,096 instances,
    # and within the row-sum yardstick of the lockstep interpreter's
    # autograd VJP (torch.func.vjp) on 1,024
    from symbolicregression_jl_tpu_torch.ops import interpreter as interp
    tcot = time.time()
    cot_report = {}
    cot_seed = torch.rand((T_OPT, ROWS), generator=gen, device=dev,
                          dtype=torch.float64) * 2 - 1
    for dt in (torch.float32, torch.float64):
        sfx = ke.STORAGE[dt][1]
        Xs, g_cot = X.to(dt), cot_seed.to(dt)
        raw = kg.stage_launch(opt_s, Xs, None, None, ops, True,
                              cotangent=True)
        _, gk, bk = raw(opt_s.cval, g_cot)
        assert gk.dtype == dt
        assert_same(f"vjp{sfx}: two launches", raw(opt_s.cval, g_cot)[1], gk)
        okc = (bk == 0) & (opt_s.length > 0)
        _, gm, okm = kg.eval_loss_grad_program_plain(
            opt_s[:4096], Xs, None, None, ops, cot=g_cot[:4096])
        assert torch.equal(okc[:4096], okm), f"vjp{sfx}: ok vs mirror"
        assert_same(f"vjp{sfx} vs mirror", gk[:4096][okm], gm[okm], "vjp" + sfx)
        tol = 1e-5 if dt == torch.float32 else 1e-13
        worst, n_cmp = 0.0, 0
        # past the invalid programs in front (the lockstep interpreter
        # runs valid programs only)
        for i in range(nf, nf + 1024, 256):
            sub = opt_s[i:i + 256]._replace(cval=opt_s.cval[i:i + 256].to(dt))
            gs = g_cot[i:i + 256]
            _, pull = torch.func.vjp(
                lambda c: interp.eval_trees(sub._replace(cval=c), Xs, ops)[0],
                sub.cval)
            ref = pull(gs)[0]
            dy = interp.eval_grad_constants(sub, Xs, ops)[2]
            yard = (gs.unsqueeze(1) * dy).abs().sum(-1)
            both = okc[i:i + 256].unsqueeze(-1) & torch.isfinite(ref) & (
                torch.isfinite(yard))
            assert torch.equal(torch.isfinite(gk[i:i + 256]) & both, both)
            d = (gk[i:i + 256] - ref).abs()[both]
            scale = yard[both].clamp_min(torch.finfo(dt).tiny)
            worst = max(worst, float((d / scale).max()) if d.numel() else 0.0)
            n_cmp += int(both.sum())
        assert worst <= tol, f"vjp{sfx} vs the interpreter's VJP: {worst}"
        cot_report[sfx or "_f32"] = dict(
            not_poisoned=int(okc.sum()), vs_interpreter_rel_to_yardstick=worst,
            compared=n_cmp)
        log(f"3g vjp{sfx}: {T_OPT} instances x {ROWS} rows, two launches the "
            f"same bits, bit-equal to its mirror on 4,096 instances, within "
            f"{worst:.3g} x the row-sum yardstick of the interpreter's "
            f"autograd VJP on {n_cmp} gradient entries of 1,024 valid instances")
    del gk, bk, okc, sub, gs, pull, ref, dy, yard, both, d
    log(f"3g cotangent mode checked in {time.time() - tcot:.1f} s")

    # ---- 3f. user operators and a user loss in every kernel ---------------------
    tuser = time.time()
    user_report = phase_user_kernels(dev, log)
    user_report["seconds"] = time.time() - tuser
    log(f"3f: {user_report['seconds']:.1f} s")

    # ---- 4. timing ----------------------------------------------------------
    n_op_nodes = lambda tb_: int((tb_.kind >= UNA).sum())

    # operations per row of each timed loss: (its elementwise loss, its
    # seed), from csrc/losses.cuh, a transcendental function counted as one
    loss_ops = {"L2DistLoss": (2, 2), "L1DistLoss": (2, 2),
                "HuberLoss": (5, 7), "LogCoshLoss": (7, 10)}

    def bound(tb_, mode, nrows, loss_name="L2DistLoss", elem=4,
              ops_per_s=F32_OPS_PER_S):
        """``elem``: bytes of an element of X, a constant and an output
        value (2 for the bfloat16 and float16 builds, 8 for float64, whose
        operations count at ``F64_OPS_PER_S``)."""
        T, L = tb_.kind.shape
        nfeat = X.shape[0]
        # four 4-byte entries and a constant per live slot (opcode, feature,
        # two operand slots, constant: the compact encoding of a program),
        # plus each tree's length and its place in the length sort
        bytes_in = (nfeat * nrows * elem + int(tb_.length.sum()) * (4 * 4 + elem)
                    + T * 8 * 2)
        if mode == ke.MODE_FUSED:
            bytes_in += nrows * 4
        bytes_out = T * 4 + {ke.MODE_VALUE: T * nrows * elem,
                             ke.MODE_FUSED: T * 4}[mode]
        ops_ = n_op_nodes(tb_) * nrows + ((loss_ops[loss_name][0] + 1) * T
                                          * nrows if mode == ke.MODE_FUSED
                                          else 0)
        t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / ops_per_s * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    plain_fn = {
        ke.MODE_VALUE: lambda tb_: [ke.eval_trees_plain(tb_[i:i + 8192], X, ops)
                                    for i in range(0, tb_.length.shape[0], 8192)],
        ke.MODE_FUSED: lambda tb_: [ke.eval_loss_trees_plain(tb_[i:i + 8192], X, y, ops)
                                       for i in range(0, tb_.length.shape[0], 8192)],
    }

    def fold_bound(tb_, ops_per_s=F32_OPS_PER_S):
        """Bytes: the fields this run's fold must read and write
        (``fold_bytes``, with the plain fold's ``changed``); operations:
        one per operator node at most."""
        t_bytes = (fold_bytes(tb_, plain_fold(tb_, ops)[1])
                   / HBM_BYTES_PER_S * 1e3)
        t_ops = n_op_nodes(tb_) / ops_per_s * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    timings = {}
    for mode in (ke.MODE_FUSED, ke.MODE_VALUE):
        name = ke.MODE_NAMES[mode]
        for tb_ in (cycle, trees):
            T = tb_.length.shape[0]
            Xm = X
            ym = y if mode == ke.MODE_FUSED else None
            prep = ke.prepare_launch(tb_, Xm, ym, ops, mode)
            ms = device_ms(lambda: ke.run_prepared(prep), 50)
            wrap = {ke.MODE_VALUE: lambda: ke.eval_trees(tb_, X, ops),
                    ke.MODE_FUSED: lambda: ke.eval_loss_trees(tb_, X, y, ops)}[mode]
            wrap_ms = cuda_ms(wrap, 20)
            plain_ms = cuda_ms(lambda: plain_fn[mode](tb_), 2)
            b_ms, b_by = bound(tb_, mode, Xm.shape[1])
            timings[(name, T)] = dict(T=T, rows=Xm.shape[1], ms=ms,
                                      wrapper_ms=wrap_ms, plain_ms=plain_ms,
                                      bound_ms=b_ms, bound_by=b_by,
                                      roofline_share=b_ms / ms,
                                      layout=prep.plan._asdict())
            log(f"layout {name} T={T}: {prep.plan.items} work items (row "
                f"ranges of {prep.plan.range} rows) per tree, "
                f"{prep.plan.rows_per_lane} rows per lane, {prep.plan.warps} "
                f"warps per block, {prep.plan.blocks_per_sm} resident blocks "
                f"per SM, X {'staged' if prep.plan.staged else 'from global'}, "
                f"{prep.plan.smem} B shared memory, {prep.plan.blocks} blocks")
            log(f"timing {name} T={T}: kernel {ms:.4f} ms, with host prep "
                f"{wrap_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
                f"({b_by}), share {b_ms / ms:.4f}, "
                f"{T * Xm.shape[1] / (ms * 1e-3):.4g} trees*rows/s")
    # the fold kernel (simplify_tree) at the cycle's and the rescore's trees
    for tb_ in (cycle, trees):
        T = tb_.length.shape[0]
        prep = ke.prepare_fold(tb_, ops)
        ms = device_ms(lambda: ke.run_fold(prep), 50)
        wrap_ms = cuda_ms(lambda: ke.fold_trees(tb_, ops), 20)
        plain_ms = cuda_ms(lambda: plain_fold(tb_, ops), 2)
        b_ms, b_by = fold_bound(tb_)
        timings[("fold", T)] = dict(T=T, rows=0, ms=ms, wrapper_ms=wrap_ms,
                                    plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, roofline_share=b_ms / ms,
                                    layout=prep.plan._asdict())
        log(f"timing fold T={T}: kernel {ms:.5f} ms, with host prep "
            f"{wrap_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
            f"({b_by}), share {b_ms / ms:.4f}; {prep.plan.blocks} blocks of "
            f"{ke.FOLD_TREES} trees, {prep.plan.smem} B shared memory")

    def grad_bound(tb_, reps, with_grad, loss_name="L2DistLoss", elem=4,
                   ops_per_s=F32_OPS_PER_S, cotangent=False):
        """Inputs read once: X, y and wn, the three int64 tree fields of
        live slots (kind, op, feature), each tree's length and sort
        position, the constants of live slots (X, y and the constants of
        ``elem`` bytes; wn, loss and gradient of the compute type, 8 bytes
        at float64); outputs: loss and poison flag per instance, and the
        gradient row.
        Operations per row: each operator node forward (and backward with
        the gradient), the elementwise loss and 2 to weigh and add it (the
        seed and 1 to weigh it): 4 (6) for L2. ``cotangent``: the
        cotangent-seeded mode, which reads a seed per instance and row in
        place of y and wn and computes a product and a sum per row."""
        elem_ops, seed_ops = loss_ops[loss_name]
        T, L = tb_.kind.shape
        N = T * reps
        acc = max(4, elem)
        live = int(tb_.length.sum())
        bytes_in = (X.shape[0] * ROWS * elem + live * 3 * 8 + T * 8 * 2
                    + reps * live * elem
                    + (N * ROWS * acc if cotangent else ROWS * (elem + acc)))
        bytes_out = N * (acc + 4) + (N * L * acc if with_grad else 0)
        row_ops = 2 if cotangent else (
            elem_ops + 2 + (seed_ops + 1 if with_grad else 0))
        ops_ = (reps * n_op_nodes(tb_) * ROWS * (2 if with_grad else 1)
                + N * ROWS * row_ops)
        t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / ops_per_s * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    gp_ = kg.grad_plan(T_OPT, 1, 24, False)
    log(f"layout loss_grad N={T_OPT}: {gp_.rows} rows per lane, {gp_.warps} "
        f"warps per block, {gp_.blocks_per_sm} resident blocks per SM, "
        f"{gp_.smem} B shared memory, {gp_.blocks} blocks")
    lp = kg.loss_plan(T_OPT, LS_STEPS, 24, False)
    log(f"layout loss N={T_OPT * LS_STEPS}: {lp.groups} warps per tree, "
        f"{lp.candidates} candidates x {lp.rows} rows per lane, {lp.warps} "
        f"warps per block, {lp.blocks_per_sm} resident blocks per SM, "
        f"{lp.smem} B shared memory, {lp.blocks} blocks")
    for name, m in (("postfix_eval", ke), ("postfix_grad", kg)):
        for line in m.BUILD_LOGS[torch.float32].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")
    for name, with_grad, reps, cv in (("loss_grad", True, 1, opt_trees.cval),
                                      ("loss", False, LS_STEPS, ls_cval)):
        raw = kg.stage_launch(opt_trees, X, y, None, ops, with_grad, reps)
        ms = device_ms(lambda: raw(cv), 50)
        fn = kg.make_loss_kernel(opt_trees, X, y, None, ops, with_grad, reps)
        wrap_ms = cuda_ms(lambda: fn(cv), 20)
        if with_grad:
            plain = lambda: [kg.eval_loss_grad_plain(opt_trees[i:i + 4096], X, y,
                                                     None, ops)
                             for i in range(0, T_OPT, 4096)]
        else:
            plain = lambda: [kg.eval_loss_plain(ls_trees[i:i + 16384], X, y,
                                                None, ops)
                             for i in range(0, T_OPT * LS_STEPS, 16384)]
        plain_ms = cuda_ms(plain, 1)
        b_ms, b_by = grad_bound(opt_trees, reps, with_grad)
        N = T_OPT * reps
        timings[(name, N)] = dict(T=N, rows=ROWS, ms=ms, wrapper_ms=wrap_ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, roofline_share=b_ms / ms)
        timings[(name, N)]["layout"] = (lp if not with_grad else gp_)._asdict()
        log(f"timing {name} N={N}: kernel {ms:.4f} ms, with the wrapper's ok "
            f"mask {wrap_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
            f"({b_by}), share {b_ms / ms:.4f}, "
            f"{N * ROWS / (ms * 1e-3):.4g} instances*rows/s")

    # B2, B3 and B4 under other losses beside L2, and the fused scoring
    # route (the wrapper: kernel, division, containment) against the value
    # route (B1, the loss in PyTorch, aggregate_loss, containment)
    loss_timing = {}
    for name in loss_ops:
        loss = tlosses.LOSS_REGISTRY[name]
        row = loss_timing[name] = {}
        for tb_ in (cycle, trees):
            T = tb_.length.shape[0]
            prep = ke.prepare_launch(tb_, X, y, ops, ke.MODE_FUSED, loss)
            row[f"B2@{T}"] = device_ms(lambda: ke.run_prepared(prep), 50)
            row[f"fused_route@{T}"] = device_ms(
                lambda: ke.eval_loss_trees(tb_, X, y, ops, loss), 20)

            def value_route():
                yv, okv = ke.eval_trees(tb_, X, ops)
                return tlosses.contain_nonfinite(
                    tlosses.aggregate_loss(loss(yv, y)), okv)

            row[f"value_route@{T}"] = device_ms(value_route, 20)
            row[f"B2_bound@{T}"] = bound(tb_, ke.MODE_FUSED, ROWS, name)[0]
            del prep
        for variant, with_grad, reps, cv in (
                ("B3", True, 1, opt_trees.cval), ("B4", False, LS_STEPS, ls_cval)):
            raw = kg.stage_launch(opt_trees, X, y, None, ops, with_grad, reps,
                                  loss)
            row[f"{variant}@{T_OPT * reps}"] = device_ms(
                lambda: raw(cv), 20 if with_grad else 10)
            row[f"{variant}_bound@{T_OPT * reps}"] = grad_bound(
                opt_trees, reps, with_grad, name)[0]
        log(f"timing under {name}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row.items()))
    # the plain versions under Huber (the any-loss kernels' record)
    huber = tlosses.LOSS_REGISTRY["HuberLoss"]
    huber_plain = dict(
        fused=cuda_ms(lambda: [ke.eval_loss_trees_plain(cycle[i:i + 8192], X, y,
                                                        ops, huber)
                               for i in range(0, T_CYCLE, 8192)], 2),
        loss_grad=cuda_ms(lambda: [kg.eval_loss_grad_plain(
            opt_trees[i:i + 4096], X, y, None, ops, loss=huber)
            for i in range(0, T_OPT, 4096)], 1),
        loss=cuda_ms(lambda: [kg.eval_loss_plain(
            ls_trees[i:i + 16384], X, y, None, ops, huber)
            for i in range(0, T_OPT * LS_STEPS, 16384)], 1))
    log(f"plain versions under HuberLoss: {huber_plain} ms")

    def host_ms(fn, reps=20):
        """Host milliseconds per call of fn, which must not wait for the
        card: the calls are queued behind a spin on the card, so the host
        clock around them reads the wrapper's own cost."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 26)  # ~30 ms of spin
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        elapsed = (time.perf_counter() - t) * 1e3 / reps
        torch.cuda.synchronize()
        return elapsed

    for name, packed in (("instr", False), ("instr_packed", True)):
        for tb_ in (cycle, trees):
            T = tb_.length.shape[0]
            prep = ki.prepare_launch(tb_, X, ops, packed)
            ms = device_ms(lambda: ki.run_prepared(prep), 50)
            wrap = lambda: ki.eval_trees_instr(tb_, X, ops, packed)
            wrap_ms = cuda_ms(wrap, 20)
            wrap_host_ms = host_ms(wrap)
            plain_ms = cuda_ms(lambda: [
                ki.eval_trees_instr_plain(tb_[i:i + 8192], X, ops, packed)
                for i in range(0, T, 8192)], 2)
            # the kernels read the tree fields as the value mode does
            b_ms, b_by = bound(tb_, ke.MODE_VALUE, ROWS)
            timings[(name, T)] = dict(T=T, rows=ROWS, ms=ms, wrapper_ms=wrap_ms,
                                      wrapper_host_ms=wrap_host_ms,
                                      plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by, roofline_share=b_ms / ms,
                                      layout=prep.plan._asdict())
            log(f"layout {name} T={T}: {prep.plan.items} work items (row "
                f"ranges of {prep.plan.range} rows) per tree, "
                f"{prep.plan.rows_per_lane} rows per lane, {prep.plan.warps} "
                f"warps per block, {prep.plan.blocks_per_sm} resident blocks "
                f"per SM, X {'staged' if prep.plan.staged else 'from global'}, "
                f"{prep.plan.smem} B shared memory, {prep.plan.blocks} blocks")
            log(f"timing {name} T={T}: kernel {ms:.4f} ms, with host prep "
                f"{wrap_ms:.4f} ms (host {wrap_host_ms:.4f} ms), plain "
                f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}), share "
                f"{b_ms / ms:.4f}, {T * ROWS / (ms * 1e-3):.4g} trees*rows/s")
    for line in ki.BUILD_LOGS[torch.float32].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"ptxas instr_eval: {line.strip()}")
    del prep

    # the bfloat16 and float16 builds beside float32's, at the same shapes
    # (phase 3e's trees), and the value route of a scoring call at those
    # dtypes (B1, the loss in PyTorch, aggregate_loss), which replaces the
    # fused route there
    from symbolicregression_jl_tpu_torch.models.fitness import (
        eval_loss_trees as fitness_loss,
    )
    storage_timing = {}
    for dt in ke.OTHER_STORAGE:
        sfx = ke.STORAGE[dt][1]
        Xs, ys, X1s = X.to(dt), y.to(dt), X1.to(dt)
        # bytes per value of X, a constant and an output, and the peak
        # operation rate of the build's compute type
        el, rate = (8, F64_OPS_PER_S) if dt == torch.float64 else (2, F32_OPS_PER_S)
        for tb_ in (cycle_s, trees_s):
            T = tb_.length.shape[0]
            chunks = lambda fn: [fn(tb_[i:i + 8192]) for i in range(0, T, 8192)]
            cases = [
                ("value", ke.prepare_launch(tb_, Xs, None, ops, ke.MODE_VALUE),
                 ke.run_prepared,
                 lambda: chunks(lambda c: ke.eval_trees_plain(c, Xs, ops)),
                 bound(tb_, ke.MODE_VALUE, ROWS, elem=el, ops_per_s=rate)),
                ("fold", ke.prepare_fold(tb_._replace(
                    cval=tb_.cval.to(dt)), ops), ke.run_fold,
                 lambda: plain_fold(tb_._replace(cval=tb_.cval.to(dt)), ops),
                 fold_bound(tb_._replace(cval=tb_.cval.to(dt)),
                            ops_per_s=rate))]
            for name, packed in (("instr", False), ("instr_packed", True)):
                cases.append((name, ki.prepare_launch(tb_, Xs, ops, packed),
                              ki.run_prepared,
                              lambda packed=packed: chunks(
                                  lambda c: ki.eval_trees_instr_plain(
                                      c, Xs, ops, packed)),
                              bound(tb_, ke.MODE_VALUE, ROWS, elem=el,
                                    ops_per_s=rate)))
            for name, prep_, run, plain, (b_ms, b_by) in cases:
                ms = device_ms(lambda: run(prep_), 50)
                plain_ms = cuda_ms(plain, 2)
                storage_timing[(name + sfx, T)] = dict(
                    T=T, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    roofline_share=b_ms / ms, f32_ms=timings[(name, T)]["ms"],
                    layout=prep_.plan._asdict())
                log(f"timing {name}{sfx} T={T}: kernel {ms:.4f} ms (float32 "
                    f"{timings[(name, T)]['ms']:.4f}), plain {plain_ms:.3f} ms, "
                    f"bound {b_ms:.5f} ms ({b_by}), share {b_ms / ms:.4f}")
            route_ms = device_ms(lambda: fitness_loss(tb_, Xs, ys, None, ops,
                                                      "L2DistLoss"), 20)
            storage_timing[("value_route" + sfx, T)] = dict(T=T, ms=route_ms)
            log(f"timing value route{sfx} T={T} (B1{sfx}, L2 in PyTorch, "
                f"aggregate_loss): {route_ms:.4f} ms per scoring call")
        for name, with_grad, reps, cv in (("loss_grad", True, 1, opt_s.cval),
                                          ("loss", False, LS_STEPS, ls_cval)):
            raw = kg.stage_launch(opt_s, Xs, ys, None, ops, with_grad, reps)
            ms = device_ms(lambda: raw(cv), 50 if with_grad else 20)
            if with_grad:
                plain = lambda: [kg.eval_loss_grad_program_plain(
                    opt_s[i:i + 4096], Xs, ys, None, ops)
                    for i in range(0, T_OPT, 4096)]
            else:
                rep_s = opt_s.map(lambda f: f.repeat_interleave(LS_STEPS, 0)
                                  )._replace(cval=ls_cval)
                plain = lambda: [kg.eval_loss_plain(rep_s[i:i + 16384], Xs, ys,
                                                    None, ops)
                                 for i in range(0, T_OPT * LS_STEPS, 16384)]
            plain_ms = cuda_ms(plain, 1)
            b_ms, b_by = grad_bound(opt_s, reps, with_grad, elem=el,
                                    ops_per_s=rate)
            N = T_OPT * reps
            storage_timing[(name + sfx, N)] = dict(
                T=N, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                roofline_share=b_ms / ms, f32_ms=timings[(name, N)]["ms"],
                layout=(kg.grad_plan(T_OPT, 1, 24, False, False, dt) if with_grad
                        else kg.loss_plan(T_OPT, reps, 24, False, False, dt)
                        )._asdict())
            log(f"timing {name}{sfx} N={N}: kernel {ms:.4f} ms (float32 "
                f"{timings[(name, N)]['ms']:.4f}), plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.5f} ms ({b_by}), share {b_ms / ms:.4f}")
    # the cotangent-seeded mode of B3 at float32 and float64, at phase 3's
    # instances, beside B3 under L2
    cot_timing = {}
    for dt in (torch.float32, torch.float64):
        sfx = ke.STORAGE[dt][1]
        Xs, g_cot = X.to(dt), cot_seed.to(dt)
        el, rate = (8, F64_OPS_PER_S) if dt == torch.float64 else (4, F32_OPS_PER_S)
        raw = kg.stage_launch(opt_s, Xs, None, None, ops, True,
                              cotangent=True)
        ms = device_ms(lambda: raw(opt_s.cval, g_cot), 50)
        plain_ms = cuda_ms(lambda: [kg.eval_loss_grad_program_plain(
            opt_s[i:i + 4096], Xs, None, None, ops, cot=g_cot[i:i + 4096])
            for i in range(0, T_OPT, 4096)], 1)
        b_ms, b_by = grad_bound(opt_s, 1, True, elem=el, ops_per_s=rate,
                                cotangent=True)
        ref_ms = (timings[("loss_grad", T_OPT)]["ms"] if dt == torch.float32
                  else storage_timing[("loss_grad_f64", T_OPT)]["ms"])
        cot_timing["vjp" + sfx] = dict(
            T=T_OPT, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            roofline_share=b_ms / ms, loss_grad_ms=ref_ms)
        log(f"timing vjp{sfx} N={T_OPT}: kernel {ms:.4f} ms (B3 under L2 at "
            f"this dtype {ref_ms:.4f}), plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}), share {b_ms / ms:.4f}")
    log(f"bounds: bytes over {HBM_BYTES_PER_S / 1e12:.2f} TB/s; operations "
        f"over {F32_OPS_PER_S / 1e12:.1f} TFLOP/s (float32 compute) or "
        f"{F64_OPS_PER_S / 1e12:.1f} TFLOP/s (float64: the H100 SXM's "
        f"non-tensor FP64 peak, half its FP32 peak); card {card}")
    # phase 3e's and this section's 2-byte tensors and the closures that
    # hold them (about 0.8 GB) go before the main path, whose peak memory
    # is read below
    del (prep_, cases, chunks, plain, raw, rep_s, Xs, ys, X1s, head, front,
         over, cycle_s, trees_s, opt_s, tb_, big, big_cv, cand, yk, okk, yp,
         okp, outs, sk, oks, sp, okps, fin, yi, oki, yip, okip, ym, bad_m,
         raw3, l3, g3, b3, l3b, g3b, b3b, ok3, lm, gm, okm, raw4, l4, b4,
         ok32, okst, g_cot, cot_seed)

    # ---- 5. the main path at full width -------------------------------------
    import symbolicregression_jl_tpu_torch.api as api_mod

    per_iter = []
    opt_s = []  # host seconds of each iteration's optimisation pass
    t_it = [time.time()]
    untimed_optimize = api_mod.optimize_islands_constants

    def timed_optimize(*a, **k):
        torch.cuda.synchronize()
        t = time.time()
        out = untimed_optimize(*a, **k)
        torch.cuda.synchronize()
        opt_s.append(time.time() - t)
        return out

    def on_iteration(j, it, cands):
        best = min(c.loss for c in cands)
        per_iter.append((time.time() - t_it[0], best))
        log(f"main path: iteration {it + 1}: {per_iter[-1][0]:.2f} s, of which "
            f"the optimisation pass {opt_s[-1]:.3f} s; best loss {best:.6g}, "
            f"frontier {len(cands)}")
        t_it[0] = time.time()

    cfg = dict(binary_operators=["+", "-", "*", "/"],
               unary_operators=["cos", "exp"], npopulations=64, npop=1000,
               maxsize=20, loss="L2DistLoss", verbosity=0)
    log(f"main path: equation_search 64 x 1000, {ROWS} rows, maxsize 20, "
        f"default constant optimisation, {args.niterations} iterations of "
        f"{args.ncycles} cycles"
        + ("" if args.ncycles == 550 else " (cut from 550 to fit the time limit)"))
    api_mod.optimize_islands_constants = timed_optimize

    def zero_counts():
        for counts in (ke.LAUNCHES, kg.LAUNCHES, ki.LAUNCHES,
                       ke.STORAGE_LAUNCHES, kg.STORAGE_LAUNCHES,
                       ki.STORAGE_LAUNCHES):
            for k in counts:
                counts[k] = 0
        for counts in (ke.LOSS_LAUNCHES, kg.LOSS_LAUNCHES, ke.USER_LAUNCHES,
                       kg.USER_LAUNCHES, ki.USER_LAUNCHES):
            counts.clear()
        for k in kr.LAUNCHES:
            kr.LAUNCHES[k] = 0
        kr.PLAN_LAUNCHES.clear()

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    cg.clear_cache()
    t_main = time.time()
    try:
        res = equation_search(X_np, y_np, niterations=args.niterations,
                              ncycles_per_iteration=args.ncycles, seed=0,
                              on_iteration=on_iteration, **cfg)
        pred = res.predict(X_np)
        torch.cuda.synchronize()
    finally:
        api_mod.optimize_islands_constants = untimed_optimize
    launches = {**ke.LAUNCHES, **kg.LAUNCHES}
    rng_launches = dict(kr.LAUNCHES)
    plan_launches = dict(kr.PLAN_LAUNCHES)
    main_by_loss = {**ke.LOSS_LAUNCHES, **kg.LOSS_LAUNCHES}
    assert not any(ki.LAUNCHES.values()), ki.LAUNCHES  # postfix path only
    storage_launches = lambda: {**ke.STORAGE_LAUNCHES, **kg.STORAGE_LAUNCHES,
                                **ki.STORAGE_LAUNCHES}
    assert not any(storage_launches().values()), storage_launches()  # float32
    assert set(main_by_loss) == {"fused:L2DistLoss", "loss_grad:L2DistLoss",
                                 "loss:L2DistLoss"}, main_by_loss
    main_s = time.time() - t_main
    total_launches = sum(launches.values())
    peak = torch.cuda.max_memory_allocated()
    # every cycle of the search is a replay of one captured step
    (main_graph,) = cg._CACHE.values()
    assert main_graph.captures == 1, main_graph.captures
    assert main_graph.replays == args.niterations * args.ncycles, (
        main_graph.replays)
    main_graph_stats = dict(captures=main_graph.captures,
                            replays=main_graph.replays,
                            capture_s=main_graph.capture_s,
                            pool_bytes=main_graph.pool_bytes)
    log(f"main path: {main_s:.1f} s, launches {launches} (total "
        f"{total_launches}), peak memory {peak / 2**30:.2f} GiB; the cycle "
        f"graph: {main_graph.captures} capture ({main_graph.capture_s:.2f} s), "
        f"{main_graph.replays} replays, its pool "
        f"{main_graph.pool_bytes / 2**30:.3f} GiB of device memory")
    log(res)
    assert res.frontier(), "empty hall of fame"
    assert len(per_iter) == args.niterations
    assert all(np.isfinite(b) for _, b in per_iter), per_iter
    assert per_iter[-1][1] <= per_iter[0][1], per_iter
    assert launches["fused"] >= args.niterations * args.ncycles, launches
    # simplify_tree: once a cycle (in the captured step) and once a rescore
    assert launches["fold"] == args.niterations * (args.ncycles + 1), launches
    # one BFGS pass per iteration: the start and 8 steps (gradient), 8 line
    # searches (loss only)
    assert launches["loss_grad"] == 9 * args.niterations, launches
    assert launches["loss"] == 8 * args.niterations, launches
    assert len(opt_s) == args.niterations, opt_s
    assert all(v > 0 for v in launches.values()), launches
    # every draw of the search went through the threefry kernel, float32
    # epilogues only (no float64 / 2-byte draw at float32): the cycle's
    # through its plans, the per-iteration draws (init, migration, constant
    # optimisation's selection, the api's splits) per call; the
    # permutation's bits are the propose plan's
    assert all(rng_launches[m] > 0 for m in RNG_SHAPES if m != "bits"), \
        rng_launches
    assert not any(v for m, v in rng_launches.items()
                   if m not in RNG_SHAPES), rng_launches
    assert all(plan_launches.get(n, 0) > 0 for n in main_path_plans()
               if n != "minibatch" and not n.endswith(F64_SUFFIX)), \
        plan_launches
    log(f"main path: threefry launches per call {rng_launches}, per plan "
        f"{plan_launches}")
    assert pred.shape == (ROWS,)
    best = res.best()
    log(f"main path: best {best.equation} loss {best.loss:.6g}; "
        f"s/iteration {[round(s, 3) for s, _ in per_iter]}, optimisation pass "
        f"s/iteration {[round(s, 3) for s in opt_s]}")

    # ---- 5b. the instruction programs at full width --------------------------
    # one iteration of INSTR_CYCLES cycles (cut from 550 to make room for
    # phase 9 in half the time limit)
    instr_runs = {}
    for program in ("instr", "instr_packed"):
        log(f"instr path: equation_search kernel_program={program!r} 64 x 1000, "
            f"{ROWS} rows, maxsize 20, default constant optimisation, 1 "
            f"iteration of {INSTR_CYCLES} cycles")
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t_i = time.time()
        it_s = []
        res_i = equation_search(
            X_np, y_np, niterations=1, ncycles_per_iteration=INSTR_CYCLES,
            seed=0, kernel_program=program,
            on_iteration=lambda j, it, c: it_s.append(time.time() - t_i),
            **cfg)
        torch.cuda.synchronize()
        run = dict(s=time.time() - t_i, s_per_iteration=it_s,
                   launches={**ke.LAUNCHES, **kg.LAUNCHES, **ki.LAUNCHES},
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   hof=[(c.complexity, c.loss, c.equation)
                        for c in res_i.frontier()])
        instr_runs[program] = run
        lc = run["launches"]
        other = "instr" if program == "instr_packed" else "instr_packed"
        # every scoring call: 1 at init, 1 per cycle, 1 rescore
        assert lc[program] == 1 + INSTR_CYCLES + 1, lc
        assert lc[other] == 0 and lc["fused"] == 0 and lc["value"] == 0, lc
        assert lc["loss_grad"] == 9 and lc["loss"] == 8, lc
        assert res_i.frontier() and np.isfinite(res_i.best_loss().loss)
        log(f"instr path {program}: {run['s']:.1f} s (iteration ends at "
            f"{[round(t, 2) for t in it_s]} s, init included), launches {lc}, "
            f"peak memory {run['peak_bytes'] / 2**30:.2f} GiB; best "
            f"{res_i.best_loss().equation} loss {res_i.best_loss().loss:.6g}")
    assert instr_runs["instr"]["hof"] == instr_runs["instr_packed"]["hof"], (
        "instr and instr_packed halls of fame differ")
    log(f"instr path: the two halls of fame are bit-equal "
        f"({len(instr_runs['instr']['hof'])} members)")

    # ---- 5c. the search builds valid programs only ----------------------------
    # the kernels report an invalid program poisoned and the plain versions
    # run it as the empty program (ke.runnable): a short search at the same
    # widths, every batch it scores, folds or optimises checked by the plain
    # derivation on the card
    # (the counts are device tensors: a captured cycle replays the check
    # with the launch, and the graph carrying it is dropped afterwards)
    n_invalid = torch.zeros((), dtype=torch.int64, device=dev)
    n_checked = torch.zeros(2, dtype=torch.int64, device=dev)

    def count_invalid(trees, X_, operators):
        invalid = ke.runnable(ke._flatten(trees), operators, X_.shape[0])[1]
        n_invalid.add_(invalid.sum())
        n_checked[0] += 1
        n_checked[1] += invalid.numel()

    prepare, stage = ke.prepare_launch, kg.stage_launch

    def prepare_checked(flat, X_, y_, operators, mode, *loss):
        count_invalid(flat, X_, operators)
        return prepare(flat, X_, y_, operators, mode, *loss)

    def stage_checked(trees, X_, y_, weights, operators, *rest):
        count_invalid(trees, X_, operators)
        return stage(trees, X_, y_, weights, operators, *rest)

    prepare_fold = ke.prepare_fold

    def prepare_fold_checked(flat, operators, X_=None):
        count_invalid(flat, X if X_ is None else X_, operators)
        return prepare_fold(flat, operators, X_)

    ke.prepare_launch, kg.stage_launch = prepare_checked, stage_checked
    ke.prepare_fold = prepare_fold_checked
    cg.clear_cache()
    try:
        equation_search(X_np, y_np, niterations=1, ncycles_per_iteration=30,
                        seed=1, **cfg)
    finally:
        ke.prepare_launch, kg.stage_launch = prepare, stage
        ke.prepare_fold = prepare_fold
        cg.clear_cache()
    n_checked = n_checked.tolist()
    assert n_checked[0] > 60, n_checked
    assert int(n_invalid) == 0, f"{int(n_invalid)} invalid programs"
    log(f"valid programs: a search of 30 cycles built no invalid program "
        f"({n_checked[0]} batches, {n_checked[1]} trees checked)")

    # ---- 5d. a search under HuberLoss at full width ----------------------------
    huber_cycles = 100
    log(f"Huber path: equation_search loss=\"HuberLoss\" 64 x 1000, {ROWS} "
        f"rows, maxsize 20, default constant optimisation, 1 iteration of "
        f"{huber_cycles} cycles")
    zero_counts()
    t_h = time.time()
    res_h = equation_search(X_np, y_np, niterations=1,
                            ncycles_per_iteration=huber_cycles, seed=0,
                            **{**cfg, "loss": "HuberLoss"})
    torch.cuda.synchronize()
    huber_run = dict(s=time.time() - t_h,
                     launches={**ke.LAUNCHES, **kg.LAUNCHES},
                     by_loss={**ke.LOSS_LAUNCHES, **kg.LOSS_LAUNCHES},
                     best=res_h.best_loss().loss)
    # every scoring call (init, each cycle, the rescore) fused under Huber,
    # one BFGS pass under Huber, no value-mode call
    assert huber_run["by_loss"] == {"fused:HuberLoss": 1 + huber_cycles + 1,
                                    "loss_grad:HuberLoss": 9,
                                    "loss:HuberLoss": 8}, huber_run
    assert huber_run["launches"]["value"] == 0, huber_run
    assert huber_run["launches"]["fold"] > 0, huber_run
    assert not any(ki.LAUNCHES.values()), ki.LAUNCHES
    assert res_h.frontier() and np.isfinite(res_h.best_loss().loss)
    log(f"Huber path: {huber_run['s']:.1f} s, launches {huber_run['launches']}, "
        f"by loss {huber_run['by_loss']}; best {res_h.best_loss().equation} "
        f"loss {res_h.best_loss().loss:.6g}")

    # ---- 5e. the north-star search at bfloat16 and float16 ----------------------
    # the same widths at precision="bfloat16", then "float16": 1 iteration of
    # 100 cycles on the default program, then 20 cycles on each instruction
    # program. Every launch must be of that dtype's builds: the value mode
    # (or B5 / B6) for every scoring call, never the fused mode (float32
    # only), the fold kernel for simplify_tree, B3 / B4 for BFGS.
    storage_runs = {}
    for precision in ("bfloat16", "float16"):
        sfx = ke.STORAGE[{"bfloat16": torch.bfloat16,
                          "float16": torch.float16}[precision]][1]
        for program, n_cyc in (("auto", 100), ("instr", 20),
                               ("instr_packed", 20)):
            zero_counts()
            t_s = time.time()
            res_s = equation_search(X_np, y_np, niterations=1,
                                    ncycles_per_iteration=n_cyc, seed=0,
                                    precision=precision, kernel_program=program,
                                    return_state=True, **cfg)
            torch.cuda.synchronize()
            run = dict(s=time.time() - t_s, cycles=n_cyc,
                       float32={**ke.LAUNCHES, **kg.LAUNCHES, **ki.LAUNCHES},
                       storage=storage_launches(),
                       by_loss={**ke.LOSS_LAUNCHES, **kg.LOSS_LAUNCHES},
                       best=res_s.best_loss().loss,
                       equation=res_s.best_loss().equation)
            storage_runs[(precision, program)] = run
            assert not any(run["float32"].values()), run  # no float32 build
            scoring = ("value" if program == "auto" else program) + sfx
            expected = {scoring: 1 + n_cyc + 1, f"loss_grad{sfx}": 9,
                        f"loss{sfx}": 8}
            for k, v in run["storage"].items():
                if k in expected:
                    assert v == expected[k], (k, run)
                elif k == f"fold{sfx}":
                    assert v == n_cyc + 1, run
                else:
                    assert v == 0, (k, run)
            assert res_s.frontier() and np.isfinite(res_s.best_loss().loss)
            assert res_s.state[0].global_hof.losses.dtype == {
                "bfloat16": torch.bfloat16, "float16": torch.float16}[precision]
            log(f"{precision} path ({program}): {run['s']:.1f} s for 1 iteration "
                f"of {n_cyc} cycles, storage launches "
                f"{ {k: v for k, v in run['storage'].items() if v} }, no "
                f"float32 launch; best {run['equation']} loss {run['best']:.6g}")

    # ---- 5f. the solo front door at full width ---------------------------------
    # the north star's widths, 1 iteration of 100 cycles per output: y of two
    # outputs (Feynman I.6.2a and 2 cos(theta) - 1) on one captured cycle;
    # output 1 against the solo search at its seed; data_policy="mask" with
    # 5 % of y's rows NaN (a weighted search: B1 for every scoring call,
    # weighted B3 / B4, no plain version reached); the CSV checkpoint and a
    # warm start from it; a resume from return_state
    from symbolicregression_jl_tpu_torch.utils.output import load_hof_csv

    door_cycles = 100
    door = {}
    frontier_bits = lambda cands: [(c.complexity, c.loss, c.equation)
                                   for c in cands]
    Y2 = np.stack([y_np, (2 * np.cos(X_np[0]) - 1).astype(np.float32)])
    out_s = []

    def note_output(j, it, cands):
        out_s.append((j, time.time()))

    def checksum(state):
        return [float(t.double().sum()) for t in cg._leaves(state.island_states)]

    log(f"front door: equation_search with 2 outputs 64 x 1000, {ROWS} rows, "
        f"maxsize 20, default constant optimisation, 1 iteration of "
        f"{door_cycles} cycles per output")
    zero_counts()
    cg.clear_cache()
    t_d = time.time()
    out_s.append((None, t_d))
    res_2 = equation_search(X_np, Y2, niterations=1,
                            ncycles_per_iteration=door_cycles, seed=0,
                            return_state=True, on_iteration=note_output, **cfg)
    torch.cuda.synchronize()
    (g2,) = cg._CACHE.values()
    door["two_outputs"] = dict(
        s=time.time() - t_d,
        s_per_output_iteration=[b[1] - a[1] for a, b in zip(out_s, out_s[1:])],
        launches={**ke.LAUNCHES, **kg.LAUNCHES},
        captures=g2.captures, replays=g2.replays,
        best=[res_2.best_loss(j).loss for j in range(2)],
        equations=[res_2.best_loss(j).equation for j in range(2)])
    run = door["two_outputs"]
    # one capture serves both outputs; every scoring call fused (init, each
    # cycle, the rescore), one BFGS pass per output
    assert g2.captures == 1 and g2.replays == 2 * door_cycles, run
    assert run["launches"]["fused"] == 2 * (1 + door_cycles + 1), run
    assert run["launches"]["loss_grad"] == 2 * 9, run
    assert run["launches"]["loss"] == 2 * 8, run
    assert run["launches"]["value"] == 0, run
    for j in range(2):
        assert res_2.frontier(j), j
        assert all(np.isfinite(c.loss) for c in res_2.frontier(j)), j
    log(f"front door, 2 outputs: {run['s']:.1f} s, {run['captures']} capture, "
        f"{run['replays']} replays, s per output iteration "
        f"{[round(s, 3) for s in run['s_per_output_iteration']]}, launches "
        f"{run['launches']}; best {run['equations']} loss {run['best']}")
    zero_counts()
    solo_1 = equation_search(X_np, Y2[1], niterations=1,
                             ncycles_per_iteration=door_cycles, seed=7919,
                             **cfg)
    assert list(cg._CACHE.values()) == [g2] and g2.captures == 1
    assert frontier_bits(solo_1.frontier()) == frontier_bits(
        res_2.frontier(1)), "output 1 differs from its solo search"
    log("front door: output 1 is bit-equal to the solo search at seed 7919 "
        f"({len(solo_1.frontier())} members), no new capture")

    # data_policy="mask": 5 % of y's rows NaN
    y_bad = y_np.copy()
    bad_rows = np.random.default_rng(5).choice(ROWS, ROWS * 5 // 100,
                                               replace=False)
    y_bad[bad_rows] = np.nan
    plain_calls = []

    def no_plain(name):
        def refuse(*a, **k):
            plain_calls.append(name)
            raise AssertionError(f"a CUDA tensor reached {name}")
        return refuse

    weighted_stages = []
    stage_unspied = kg.stage_launch

    def stage_spy(trees, X_, y_, weights, *rest, **kw):
        weighted_stages.append(weights is not None)
        return stage_unspied(trees, X_, y_, weights, *rest, **kw)

    from symbolicregression_jl_tpu_torch.models import mutate_device as tmut

    plains = [(ke, "eval_trees_plain"), (ke, "eval_loss_trees_plain"),
              (ke, "eval_slot_values_plain"), (tmut, "simplify_tree_plain"),
              (kg, "_plain_loss_grad"),
              (ki, "eval_trees_instr_plain")]
    saved = [getattr(m, n) for m, n in plains]
    for m, n in plains:
        setattr(m, n, no_plain(n))
    kg.stage_launch = stage_spy
    zero_counts()
    t_d = time.time()
    try:
        res_m = equation_search(X_np, y_bad, niterations=1,
                                ncycles_per_iteration=door_cycles, seed=0,
                                data_policy="mask", **cfg)
        torch.cuda.synchronize()
    finally:
        for (m, n), f in zip(plains, saved):
            setattr(m, n, f)
        kg.stage_launch = stage_unspied
    graphs = list(cg._CACHE.values())
    gm = [g for g in graphs if g is not g2]
    door["mask"] = dict(
        s=time.time() - t_d, launches={**ke.LAUNCHES, **kg.LAUNCHES},
        by_loss={**ke.LOSS_LAUNCHES, **kg.LOSS_LAUNCHES},
        masked_rows=res_m.dataset_diagnostics["masked_rows"],
        captures=[g.captures for g in graphs],
        weighted_stages=len(weighted_stages),
        best=res_m.best_loss().loss, equation=res_m.best_loss().equation)
    run = door["mask"]
    assert run["masked_rows"] == len(bad_rows), run
    assert not plain_calls, plain_calls
    # the weighted cells have their own graph key: one more capture
    assert len(gm) == 1 and gm[0].captures == 1, run
    assert gm[0].weights is not None and g2.captures == 1, run
    assert run["launches"]["value"] == 1 + door_cycles + 1, run
    assert run["launches"]["fused"] == 0, run
    assert run["launches"]["loss_grad"] == 9 and run["launches"]["loss"] == 8
    assert weighted_stages and all(weighted_stages), weighted_stages
    assert all(np.isfinite(c.loss) for c in res_m.frontier()), res_m
    log(f"front door, mask: {run['s']:.1f} s, {run['masked_rows']} rows "
        f"masked, captures per graph {run['captures']}, launches "
        f"{run['launches']}, {run['weighted_stages']} BFGS stagings all "
        f"weighted, no plain-version call; best {run['equation']} loss "
        f"{run['best']:.6g}")

    # the CSV checkpoint, its round trip, and a warm start from it
    csv_dir = tempfile.TemporaryDirectory()
    csv = os.path.join(csv_dir.name, "hof.csv")
    t_d = time.time()
    res_c = equation_search(X_np, y_np, niterations=1,
                            ncycles_per_iteration=door_cycles, seed=3,
                            output_file=csv, **cfg)
    back = load_hof_csv(csv, res_c.options)
    assert [(c.complexity, c.equation) for c in back] == [
        (c.complexity, c.equation) for c in res_c.frontier()], "CSV round trip"
    res_w = equation_search(X_np, y_np, niterations=1,
                            ncycles_per_iteration=door_cycles, seed=99,
                            warm_start_file=csv, **cfg)
    torch.cuda.synchronize()
    best_c = min(c.loss for c in res_c.frontier())
    best_w = min(c.loss for c in res_w.frontier())
    assert best_w <= best_c + 1e-5, (best_w, best_c)
    csv_dir.cleanup()
    door["csv"] = dict(s=time.time() - t_d, members=len(back),
                       best=best_c, warm_best=best_w)
    log(f"front door, CSV: {len(back)} members round trip exact (equations "
        f"and complexities); warm start best loss {best_w:.6g} against "
        f"{best_c:.6g}; {door['csv']['s']:.1f} s for both searches")

    # a resume of both outputs from return_state
    before = [checksum(s) for s in res_2.state]
    zero_counts()
    t_d = time.time()
    res_r = equation_search(X_np, Y2, niterations=1,
                            ncycles_per_iteration=door_cycles, seed=0,
                            saved_state=res_2.state, return_state=True, **cfg)
    torch.cuda.synchronize()
    door["resume"] = dict(s=time.time() - t_d,
                          iterations=[s.iteration for s in res_r.state],
                          best=[res_r.best_loss(j).loss for j in range(2)])
    assert [checksum(s) for s in res_2.state] == before, "saved state changed"
    assert door["resume"]["iterations"] == [2, 2], door["resume"]
    for j in range(2):
        assert res_r.best_loss(j).loss <= res_2.best_loss(j).loss, j
    assert sum(g.captures for g in cg._CACHE.values()) == 2, [
        g.captures for g in cg._CACHE.values()]
    log(f"front door, resume: {door['resume']['s']:.1f} s, iterations "
        f"{door['resume']['iterations']}, best {door['resume']['best']} "
        f"(before {door['two_outputs']['best']}); the saved state unchanged; "
        "2 captures in all (one per graph key)")
    del res_2, res_r, res_m, res_c, res_w, solo_1, g2, gm, graphs
    cg.clear_cache()

    # ---- 5g. user operators and a loss callable at full width --------------------
    # the north star's widths over + * op2c | op3c cos under the loss
    # callable, 1 iteration of 100 cycles, with BFGS, then Nelder-Mead, then
    # Newton; every plain version replaced by a raising stub. Every scoring
    # call fuses in B2's user instantiation, none takes the value mode, and
    # no registry library launches; the optimiser runs on the user
    # instantiations of B3 / B4, each pass timed.
    user_cycles = 100
    ucfg = dict(cfg, binary_operators=["+", "*", "op2c"],
                unary_operators=["op3c", "cos"], loss=user_loss)
    user_runs = {}
    for algo in ("BFGS", "NelderMead", "Newton"):
        log(f"user path: equation_search over + * op2c | op3c cos, "
            f"loss=(p - t) ** 2, 64 x 1000, {ROWS} rows, maxsize 20, "
            f"optimizer_algorithm={algo!r}, 1 iteration of {user_cycles} "
            "cycles")
        zero_counts()
        plain_calls.clear()
        saved = [getattr(m, n) for m, n in plains]
        for m, n in plains:
            setattr(m, n, no_plain(n))
        opt_s.clear()
        api_mod.optimize_islands_constants = timed_optimize
        t_u = time.time()
        try:
            res_u = equation_search(X_np, y_np, niterations=1,
                                    ncycles_per_iteration=user_cycles, seed=0,
                                    optimizer_algorithm=algo, **ucfg)
            torch.cuda.synchronize()
        finally:
            for (m, n), f in zip(plains, saved):
                setattr(m, n, f)
            api_mod.optimize_islands_constants = untimed_optimize
        run = user_runs[algo] = dict(
            s=time.time() - t_u, user_eval=dict(ke.USER_LAUNCHES),
            user_grad=dict(kg.USER_LAUNCHES),
            registry={**ke.LAUNCHES, **kg.LAUNCHES},
            by_loss={**ke.LOSS_LAUNCHES, **kg.LOSS_LAUNCHES},
            optimize_ms=[v * 1e3 for v in opt_s],
            best=res_u.best_loss().loss, equation=res_u.best_loss().equation,
            plain_calls=len(plain_calls))
        expect_opt = {"BFGS": {"loss_grad": 9, "loss": 8},
                      "NelderMead": {"loss": 1 + 3 * 8},
                      "Newton": {"loss_grad": 8, "loss": 8}}[algo]
        assert run["plain_calls"] == 0, plain_calls
        assert run["user_eval"].get("fused") == 1 + user_cycles + 1, run
        assert run["user_eval"].get("value", 0) == 0, run
        assert run["user_eval"].get("fold", 0) == user_cycles + 1, run
        assert not any(run["registry"].values()), run
        assert run["user_grad"] == expect_opt, run
        assert run["by_loss"]["fused:UserLoss"] == 1 + user_cycles + 1, run
        assert res_u.frontier() and np.isfinite(run["best"]), run
        assert len(opt_s) == 1, opt_s
        log(f"user path {algo}: {run['s']:.1f} s, user launches "
            f"{run['user_eval']} {run['user_grad']}, registry launches "
            f"{run['registry']}, optimisation pass "
            f"{run['optimize_ms'][0]:.2f} ms, 0 plain calls; best "
            f"{run['equation']} loss {run['best']:.6g}")
    # the user instantiations the runs above do not reach: B1's value mode
    # (a weighted search scores through it, then the loss), B5 and B6 (the
    # instruction programs), 20 cycles each, plain versions stubbed
    for label, kw in (("weighted", dict(weights=np.ones(ROWS, np.float32))),
                      ("instr", dict(kernel_program="instr")),
                      ("instr_packed", dict(kernel_program="instr_packed"))):
        zero_counts()
        plain_calls.clear()
        saved = [getattr(m, n) for m, n in plains]
        for m, n in plains:
            setattr(m, n, no_plain(n))
        t_u = time.time()
        try:
            res_u = equation_search(X_np, y_np, niterations=1,
                                    ncycles_per_iteration=20, seed=0,
                                    **kw, **ucfg)
            torch.cuda.synchronize()
        finally:
            for (m, n), f in zip(plains, saved):
                setattr(m, n, f)
        run = user_runs[label] = dict(
            s=time.time() - t_u, user_eval=dict(ke.USER_LAUNCHES),
            user_grad=dict(kg.USER_LAUNCHES),
            user_instr=dict(ki.USER_LAUNCHES),
            registry={**ke.LAUNCHES, **kg.LAUNCHES, **ki.LAUNCHES},
            plain_calls=len(plain_calls), best=res_u.best_loss().loss)
        assert run["plain_calls"] == 0, plain_calls
        assert not any(run["registry"].values()), run
        assert res_u.frontier() and np.isfinite(run["best"]), run
        key = {"weighted": ("user_eval", "value"),
               "instr": ("user_instr", "instr"),
               "instr_packed": ("user_instr", "instr_packed")}[label]
        assert run[key[0]].get(key[1], 0) >= 1 + 20 + 1, run
        log(f"user path {label} (20 cycles): {run['s']:.1f} s, user launches "
            f"{run['user_eval']} {run['user_grad']} {run['user_instr']}")
    del res_u
    cg.clear_cache()

    # ---- 5h. float64, a custom objective and per-island minibatches -------------
    # the north star's widths (64 x 1000, 2,048 rows, maxsize 20, + - * /,
    # cos exp), every plain version a raising stub (the lockstep
    # interpreter's eval_trees too), each run's counts zeroed just before
    # and read just after:
    # (a) precision="float64": 1 iteration of 100 cycles with default BFGS,
    #     then 20 cycles on each instruction program: every launch one of
    #     the float64 builds, no fused launch, no float32 library;
    # (b) loss_function= the mean squared error through eval_tree, 1
    #     iteration of 100 cycles with BFGS: every scoring call one B1
    #     launch and no B2; BFGS's gradient on B3's cotangent mode (with a
    #     B1 launch for its forward), its line search on B1;
    # (c) batching=True, batch_size=50, independent_island_batches=True,
    #     100 cycles: all replays of one capture (so no host wait in the
    #     step), one B2 launch per replayed cycle over the 64 islands'
    #     minibatches (the per-set form).
    from symbolicregression_jl_tpu_torch.ops import interpreter as interp

    def objective_mse(tree, X_, y_, weights_, options_):
        """The reference's custom objective (tests/test_aux.py:143-147) on
        the port: eval_tree and torch.where, the mean squared error."""
        pred, ok = interp.eval_tree(tree, X_, options_.operators)
        mse = torch.mean((pred - y_) ** 2)
        return torch.where(ok, mse, torch.inf)

    stubbed = plains + [(interp, "eval_trees")]
    vjp_counts = kg.VJP_LAUNCHES

    def run_stubbed(**kw):
        zero_counts()
        for k in vjp_counts:
            vjp_counts[k] = 0
        plain_calls.clear()
        interp.PLAIN_CALLS["eval_tree"] = 0
        saved = [getattr(m, n) for m, n in stubbed]
        for m, n in stubbed:
            setattr(m, n, no_plain(n))
        opt_s.clear()
        api_mod.optimize_islands_constants = timed_optimize
        t_r = time.time()
        its = []
        try:
            res_r = equation_search(
                X_np, y_np, niterations=1, seed=0, return_state=True,
                on_iteration=lambda j, it, c: its.append(time.time() - t_r),
                **{**cfg, **kw})
            torch.cuda.synchronize()
        finally:
            for (m, n), f in zip(stubbed, saved):
                setattr(m, n, f)
            api_mod.optimize_islands_constants = untimed_optimize
        graphs = list(cg._CACHE.values())
        return res_r, dict(
            s=time.time() - t_r, s_per_iteration=its,
            float32={**ke.LAUNCHES, **kg.LAUNCHES, **ki.LAUNCHES},
            plans=dict(kr.PLAN_LAUNCHES),
            storage={k: v for k, v in storage_launches().items() if v},
            vjp={k: v for k, v in vjp_counts.items() if v},
            by_loss={**ke.LOSS_LAUNCHES, **kg.LOSS_LAUNCHES},
            optimize_ms=[v * 1e3 for v in opt_s],
            plain_calls=len(plain_calls),
            interpreter_calls=interp.PLAIN_CALLS["eval_tree"],
            captures=sum(g.captures for g in graphs),
            replays=sum(g.replays for g in graphs),
            best=res_r.best_loss().loss, equation=res_r.best_loss().equation)

    slice_runs = {}
    for program, n_cyc in (("auto", 100), ("instr", 20), ("instr_packed", 20)):
        cg.clear_cache()
        res_f, run = run_stubbed(precision="float64", kernel_program=program,
                                 ncycles_per_iteration=n_cyc)
        slice_runs[f"float64:{program}"] = run
        scoring = ("value" if program == "auto" else program) + "_f64"
        expected = {scoring: 1 + n_cyc + 1, "loss_grad_f64": 9, "loss_f64": 8}
        assert run["plain_calls"] == 0 and not any(run["float32"].values()), run
        assert not run["vjp"], run
        for k, v in run["storage"].items():
            if k in expected:
                assert v == expected[k], (k, run)
            else:
                assert k == "fold_f64" and v == n_cyc + 1, (k, run)
        assert res_f.state[0].global_hof.losses.dtype == torch.float64
        assert res_f.state[0].island_states.pop.trees.cval.dtype == torch.float64
        assert run["captures"] == 1 and run["replays"] == n_cyc, run
        log(f"5h(a) float64 ({program}): {run['s']:.1f} s for 1 iteration of "
            f"{n_cyc} cycles (iteration ends at "
            f"{[round(v, 2) for v in run['s_per_iteration']]} s, init "
            f"included), optimisation pass "
            f"{[round(v, 2) for v in run['optimize_ms']]} ms, launches "
            f"{run['storage']}, no float32 launch, 0 plain calls; best "
            f"{run['equation']} loss {run['best']:.10g}")
    cg.clear_cache()
    res_c, run = run_stubbed(loss_function=objective_mse,
                             ncycles_per_iteration=100)
    slice_runs["loss_function"] = run
    # scoring: init, 100 cycles, rescore; the baseline: one tree; BFGS: 9
    # gradients (each a B1 forward and a cotangent launch) and 8 line
    # searches
    assert run["plain_calls"] == 0 and run["interpreter_calls"] == 0, run
    assert run["float32"]["fused"] == 0 and run["float32"]["value"] == (
        1 + 100 + 1) + 1 + 9 + 8, run
    assert run["float32"]["loss_grad"] == 0 and run["float32"]["loss"] == 0
    assert run["vjp"] == {"vjp": 9}, run
    assert run["captures"] == 1 and run["replays"] == 100, run
    assert res_c.frontier() and np.isfinite(run["best"]), run
    log(f"5h(b) loss_function (MSE through eval_tree): {run['s']:.1f} s for "
        f"1 iteration of 100 cycles, optimisation pass "
        f"{[round(v, 2) for v in run['optimize_ms']]} ms, launches "
        f"{ {k: v for k, v in run['float32'].items() if v} } and cotangent "
        f"{run['vjp']}: 102 scoring calls, each one B1 launch, 0 B2, BFGS's "
        f"gradient on B3's cotangent mode; best {run['equation']} loss "
        f"{run['best']:.6g}")
    # the same objective at float64, 20 cycles: every launch of the
    # float64 builds, BFGS's gradient on the float64 cotangent mode
    cg.clear_cache()
    res_c, run = run_stubbed(loss_function=objective_mse, precision="float64",
                             ncycles_per_iteration=20)
    slice_runs["loss_function_f64"] = run
    assert run["plain_calls"] == 0 and run["interpreter_calls"] == 0, run
    assert not any(run["float32"].values()), run
    assert run["storage"] == {"value_f64": (1 + 20 + 1) + 1 + 9 + 8,
                              "fold_f64": 20 + 1}, run
    assert run["vjp"] == {"vjp_f64": 9}, run
    log(f"5h(b) loss_function at float64 (20 cycles): {run['s']:.1f} s, "
        f"launches {run['storage']} and cotangent {run['vjp']}")
    cg.clear_cache()
    res_b, run = run_stubbed(batching=True, batch_size=50,
                             independent_island_batches=True,
                             ncycles_per_iteration=100)
    slice_runs["island_batches"] = run
    assert run["plain_calls"] == 0, run
    assert run["captures"] == 1 and run["replays"] == 100, run
    # the fused scoring calls: one per replayed cycle for the 64 islands'
    # minibatches (the per-set form), plus init and the rescore on the full
    # data
    assert run["float32"]["fused"] == 100 + 2, run
    assert run["float32"]["value"] == 0, run
    assert run["float32"]["loss_grad"] == 9 and run["float32"]["loss"] == 8
    # the minibatch chain: one plan launch per replayed cycle
    assert run["plans"].get("minibatch") == 100, run["plans"]
    assert res_b.frontier() and np.isfinite(run["best"]), run
    log(f"5h(c) independent_island_batches (batch 50): {run['s']:.1f} s for "
        f"100 cycles, 1 capture and {run['replays']} replays (no host wait "
        f"in the captured step), launches "
        f"{ {k: v for k, v in run['float32'].items() if v} } (1 B2 per "
        f"replayed cycle for the 64 islands); best {run['equation']} loss "
        f"{run['best']:.6g}")
    del res_f, res_c, res_b
    cg.clear_cache()

    # ---- 6. the cycle alone ---------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from symbolicregression_jl_tpu_torch.models.dataset import (
        make_dataset, update_baseline_loss,
    )
    from symbolicregression_jl_tpu_torch.models.evolve import (
        init_island_state, s_r_cycle_islands,
    )
    from symbolicregression_jl_tpu_torch.models.options import make_options
    from symbolicregression_jl_tpu_torch.tools.kernel_breakdown import (
        sync_counts,
    )

    opts = make_options(**cfg)
    base = update_baseline_loss(make_dataset(X, y, device=dev),
                                opts).baseline_loss
    st = init_island_state(keyrng.split(keyrng.key(2, dev), 64), opts, 1, X,
                           y, None, base)

    def cycles(n, loop=s_r_cycle_islands):
        nonlocal st
        torch.cuda.synchronize()
        tc = time.time()
        st = loop(st, opts.maxsize, X, y, None, base, opts, ncycles=n)
        torch.cuda.synchronize()
        return (time.time() - tc) * 1e3 / n

    cycles(5)  # warm-up
    from symbolicregression_jl_tpu_torch.models import mutate_device as tmut

    kernel_fold = ke.fold_trees

    def fold_with(variant):
        """The cycle's simplify_tree through the fold kernel or, for
        ``plain_fold``, through the plain fold on the same card tensors."""
        ke.fold_trees = (kernel_fold if variant == "kernel_fold"
                         else tmut.simplify_tree_plain)

    # the eager cycle with the fold on the kernel against the same cycle
    # with the plain fold: the same bits after 10 cycles from one state
    ends = {}
    for variant in ("kernel_fold", "plain_fold"):
        fold_with(variant)
        try:
            ends[variant] = s_r_cycle_islands(st, opts.maxsize, X, y, None,
                                              base, opts, ncycles=10)
        finally:
            fold_with("kernel_fold")
    fold_leaves = list(zip(cg._leaves(ends["kernel_fold"]),
                           cg._leaves(ends["plain_fold"])))
    n_fold_differ = sum(not torch.equal(a, b) for a, b in fold_leaves)
    assert n_fold_differ == 0, (
        f"the kernel fold's cycle differs from the plain fold's in "
        f"{n_fold_differ} of {len(fold_leaves)} state fields")
    del ends
    log(f"cycle alone: 10 eager cycles with the fold kernel bit-equal to 10 "
        f"with the plain fold from one state (all {len(fold_leaves)} "
        "IslandState fields)")
    cycle_ms = {"kernel_fold": [], "plain_fold": []}
    for variant in ("kernel_fold", "plain_fold", "kernel_fold", "plain_fold"):
        fold_with(variant)
        try:
            cycle_ms[variant].append(cycles(20))
        finally:
            fold_with("kernel_fold")
        log(f"cycle alone: {variant}: {cycle_ms[variant][-1]:.2f} ms per cycle "
            "(20 cycles, eager, host clock)")

    def cycle_profile_of(n, loop):
        """(profile, wall ms) of n cycles through ``loop``."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_:
            wall = cycles(n, loop) * n
        return prof_, wall

    def device_busy(prof_):
        ka_ = prof_.key_averages()
        attr = ("self_device_time_total"
                if hasattr(ka_[0], "self_device_time_total")
                else "self_cuda_time_total")
        ev = [e for e in ka_ if e.device_type == DeviceType.CUDA]
        return (ka_, attr, sum(getattr(e, attr) for e in ev) / 1e3,
                sum(e.count for e in ev))

    prof_cycles = 20
    prof, prof_ms = cycle_profile_of(prof_cycles, s_r_cycle_islands)
    ka, dev_attr, busy_ms, n_kernels = device_busy(prof)
    assert n_kernels, "the profiler recorded no device activity"
    log(ka.table(sort_by=dev_attr, row_limit=15))
    kernel_cycle = min(cycle_ms["kernel_fold"])
    cycle_profile = dict(
        cycles=prof_cycles, wall_ms_profiled=prof_ms, device_busy_ms=busy_ms,
        kernels_per_cycle=n_kernels / prof_cycles,
        idle_share_profiled=1 - busy_ms / prof_ms,
        idle_share_unprofiled=1 - busy_ms / prof_cycles / kernel_cycle)
    log(f"cycle alone, eager, profiled: {prof_cycles} cycles, wall "
        f"{prof_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"{n_kernels / prof_cycles:.0f} device kernels per cycle, idle share "
        f"{cycle_profile['idle_share_profiled']:.3f} under the profiler, "
        f"{cycle_profile['idle_share_unprofiled']:.3f} against the unprofiled "
        f"{kernel_cycle:.2f} ms per cycle")
    by_call, by_op = sync_counts(prof)
    # the explicit torch.cuda.synchronize() around the cycles and the
    # profiler's own have no issuing operator
    cycle_waits = {k: n for k, n in by_op.items()
                   if "Synchronize" in k and " <- None " not in k}
    cycle_copies = {c: n for c, n in by_call.items()
                    if "HtoD" in c or "DtoH" in c}
    cycle_profile.update(
        host_waits_per_cycle=sum(cycle_waits.values()) / prof_cycles,
        host_calls=dict(by_call),
        host_calls_by_operator=dict(by_op.most_common(20)))
    log(f"cycle alone: {sum(cycle_waits.values()) / prof_cycles:.2f} waits for "
        f"the card per cycle; runtime calls and device copies in {prof_cycles} "
        f"cycles {dict(by_call)}; by issuing operator: "
        f"{dict(by_op.most_common(20))}")
    assert not cycle_waits and not cycle_copies, (
        f"the eager cycle waits for the card: {cycle_waits} {cycle_copies}")

    # the cycle captured as a CUDA graph against the eager loop: the same
    # bits after 20 cycles from one state and seed, then A B B A timing
    # over 50 cycles each, then a profile of 20 replayed cycles
    graph_cycles = cg.s_r_cycle_islands_graph
    st0 = st
    zero_counts()
    eager20 = s_r_cycle_islands(st0, opts.maxsize, X, y, None, base, opts,
                                ncycles=20)
    eager_counts = [dict(c) for c in cg.LAUNCH_COUNTERS]
    zero_counts()
    graph20 = graph_cycles(st0, opts.maxsize, X, y, None, base, opts,
                           ncycles=20)
    graph_counts = [dict(c) for c in cg.LAUNCH_COUNTERS]
    torch.cuda.synchronize()
    leaves = list(zip(cg._leaves(eager20), cg._leaves(graph20)))
    n_differ = sum(not torch.equal(a, b) for a, b in leaves)
    assert n_differ == 0, f"{n_differ} of {len(leaves)} state fields differ"
    assert not torch.equal(graph20.key, st0.key)  # the keys moved on
    assert eager_counts == graph_counts, (eager_counts, graph_counts)
    # what one replay launches: its capture's counts (the per-call split
    # of the minibatch chain's start runs once per call, outside it)
    (cyc_graph,) = [g for g in cg._CACHE.values() if g.X.shape == X.shape
                    and g.options == opts]
    delta = dict(zip(map(id, cg.LAUNCH_COUNTERS), cyc_graph.launch_delta))
    rng_per_cycle = {k: float(v) for k, v in delta[id(kr.LAUNCHES)].items()
                     if v}
    plan_per_cycle = {k: float(v) for k, v in
                      delta[id(kr.PLAN_LAUNCHES)].items() if v}
    per_replay = sum(rng_per_cycle.values()) + sum(plan_per_cycle.values())
    assert kr.PLAN_LAUNCHES == {k: 20 * v for k, v in plan_per_cycle.items()}
    log(f"cycle graph: 20 replayed cycles bit-equal to 20 eager cycles from "
        f"one state (all {len(leaves)} IslandState fields, the islands' keys "
        f"included), launch counts equal {graph_counts[:3]}; threefry "
        f"launches per replayed cycle {per_replay}: per call "
        f"{rng_per_cycle}, by plan {plan_per_cycle}")
    # every draw of the cycle through a plan: propose, mutate (every branch
    # and the random-tree loop in one launch) and crossover, once each
    assert not rng_per_cycle, rng_per_cycle
    assert plan_per_cycle == {"propose": 1.0, "mutate": 1.0,
                              "crossover": 1.0}, plan_per_cycle
    assert per_replay <= 24, per_replay
    # the cycle's simplify_tree: one launch of the fold kernel per replay
    fold_per_cycle = delta[id(ke.LAUNCHES)].get("fold", 0)
    assert fold_per_cycle == 1, delta[id(ke.LAUNCHES)]
    del eager20, graph20, st0
    graph_ms = {"eager": [], "captured": []}
    n_ab = 50
    for variant in ("eager", "captured", "captured", "eager"):
        graph_ms[variant].append(cycles(
            n_ab, s_r_cycle_islands if variant == "eager" else graph_cycles))
        log(f"cycle A/B: {variant}: {graph_ms[variant][-1]:.3f} ms per cycle "
            f"({n_ab} cycles, host clock)")
    prof, gprof_ms = cycle_profile_of(prof_cycles, graph_cycles)
    gka, _, gbusy_ms, g_kernels = device_busy(prof)
    log(gka.table(sort_by=dev_attr, row_limit=12))
    g_calls, _ = sync_counts(prof)
    graph_report = dict(
        fold_launches_per_replay=fold_per_cycle,
        threefry_per_cycle=rng_per_cycle, plans_per_cycle=plan_per_cycle,
        threefry_launches_per_replay=per_replay,
        ms_per_cycle=graph_ms, cycles_per_timing=n_ab,
        captures=cyc_graph.captures, replays=cyc_graph.replays,
        capture_s=cyc_graph.capture_s, pool_bytes=cyc_graph.pool_bytes,
        kernels_per_replayed_cycle=g_kernels / prof_cycles,
        wall_ms_profiled=gprof_ms, device_busy_ms=gbusy_ms,
        idle_share_profiled=1 - gbusy_ms / gprof_ms,
        idle_share_unprofiled=1 - gbusy_ms / prof_cycles
        / min(graph_ms["captured"]),
        host_calls=dict(g_calls))
    log(f"cycle graph ({card}): eager {graph_ms['eager']} ms per cycle, "
        f"captured {graph_ms['captured']} ms per cycle (A B B A, {n_ab} "
        f"cycles each); {cyc_graph.captures} capture(s) "
        f"({cyc_graph.capture_s:.3f} s), {cyc_graph.replays} replays, pool "
        f"{cyc_graph.pool_bytes / 2**30:.3f} GiB; profiled {prof_cycles} "
        f"replayed cycles: {g_kernels / prof_cycles:.0f} device kernels per "
        f"cycle, device busy {gbusy_ms:.1f} ms of {gprof_ms:.1f} ms, idle "
        f"share {graph_report['idle_share_profiled']:.3f} under the profiler, "
        f"{graph_report['idle_share_unprofiled']:.3f} against the unprofiled "
        f"captured cycle; runtime calls {dict(g_calls)}")
    # the scoring wrapper alone: the cycle's fused scoring and fold calls
    # must not wait for the card
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ke.eval_loss_trees(cycle, X, y, ops)
            ke.fold_trees(cycle, ops)
    wrapper_calls, wrapper_ops = sync_counts(prof)
    cycle_profile["scoring_wrapper_host_calls"] = dict(wrapper_calls)
    log(f"scoring wrapper alone (10 fused + 10 fold calls at "
        f"{T_CYCLE} trees): {dict(wrapper_calls)}, by operator "
        f"{dict(wrapper_ops)}")
    # the profiler's own closing synchronize has no issuing operator
    waits = [k for k in wrapper_ops if "Synchronize" in k and " <- None " not in k]
    copies = [c for c in wrapper_calls if "HtoD" in c or "DtoH" in c]
    assert not waits and not copies, f"the scoring wrapper waits: {waits} {copies}"
    # the instruction programs' scoring call (B5 / B6, then the loss in
    # PyTorch), as the instr path's cycle makes it
    from symbolicregression_jl_tpu_torch.models.fitness import (
        eval_loss_trees as fitness_loss,
    )

    for program in ("instr", "instr_packed"):
        fitness_loss(cycle, X, y, None, ops, "L2DistLoss", program=program)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fitness_loss(cycle, X, y, None, ops, "L2DistLoss", program=program)
        i_calls, i_ops = sync_counts(prof)
        i_waits = [k for k in i_ops if "Synchronize" in k and " <- None " not in k]
        i_copies = [c for c in i_calls if "HtoD" in c or "DtoH" in c]
        cycle_profile[f"{program}_scoring_host_calls"] = dict(i_calls)
        log(f"{program} scoring call alone (10 calls at {T_CYCLE} trees): "
            f"{dict(i_calls)}, by operator {dict(i_ops)}")
        assert not i_waits and not i_copies, (
            f"the {program} scoring call waits: {i_waits} {i_copies}")

    # ---- 7. the optimisation pass alone ----------------------------------------
    from symbolicregression_jl_tpu_torch.models.evolve import (
        optimize_islands_constants,
    )

    def opt_pass():
        nonlocal st
        torch.cuda.synchronize()
        tc = time.time()
        st = optimize_islands_constants(keyrng.split(keyrng.key(7, dev), 64),
                                        st, X, y, None, base, opts)
        torch.cuda.synchronize()
        return (time.time() - tc) * 1e3

    opt_pass()  # warm-up
    pass_ms = [opt_pass() for _ in range(3)]
    before = dict(kg.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_pass_ms = opt_pass()
    assert kg.LAUNCHES["loss_grad"] - before["loss_grad"] == 9
    assert kg.LAUNCHES["loss"] - before["loss"] == 8
    ka = prof.key_averages()
    log(ka.table(sort_by=dev_attr, row_limit=12))
    pass_ev = [e for e in ka if e.device_type == DeviceType.CUDA]
    assert pass_ev, "the profiler recorded no device activity"
    pass_busy = sum(getattr(e, dev_attr) for e in pass_ev) / 1e3
    grad_dev = sum(getattr(e, dev_attr) for e in pass_ev
                   if "postfix_grad_kernel" in e.key
                   or "loss_kernel" in e.key) / 1e3
    by_events = (9 * timings[("loss_grad", T_OPT)]["ms"]
                 + 8 * timings[("loss", T_OPT * LS_STEPS)]["ms"])
    pass_profile = dict(
        ms_per_pass=pass_ms, wall_ms_profiled=prof_pass_ms,
        device_busy_ms=pass_busy,
        device_kernels=sum(e.count for e in pass_ev),
        grad_kernels_device_ms=grad_dev,
        kernel_share_profiled=grad_dev / min(pass_ms),
        kernel_share_by_events=by_events / min(pass_ms),
        idle_share_unprofiled=1 - pass_busy / min(pass_ms))
    log(f"optimisation pass alone (64 x 1000, {T_OPT} BFGS instances): "
        f"{[round(m, 2) for m in pass_ms]} ms per pass (host clock); profiled: "
        f"{pass_profile['device_kernels']} device kernels, device busy "
        f"{pass_busy:.2f} ms, the two kernels {grad_dev:.2f} ms of it; kernel "
        f"share {pass_profile['kernel_share_profiled']:.3f} (profiler) / "
        f"{pass_profile['kernel_share_by_events']:.3f} (9 x gradient + 8 x "
        f"loss-only kernel ms from phase 4), idle share "
        f"{pass_profile['idle_share_unprofiled']:.3f}")

    # ---- 8. recovery on the card -------------------------------------------
    rng = np.random.default_rng(0)
    Xr = rng.integers(-3, 4, size=(5, 100)).astype(np.float32)
    yr = Xr[0] * Xr[0] - Xr[1] * Xr[2]
    tr = time.time()
    rec = equation_search(Xr, yr, binary_operators=["+", "-", "*"],
                          should_optimize_constants=False, npopulations=16,
                          npop=100, tournament_selection_n=6,
                          ncycles_per_iteration=40, maxsize=12,
                          niterations=30, seed=0, early_stop_condition=1e-6,
                          verbosity=0)
    rb = rec.best_loss()
    log(f"recovery: {rb.equation} loss {rb.loss:.3g} after {rec.iterations} "
        f"iterations, {time.time() - tr:.1f} s")
    assert rb.loss < 1e-6, rec
    # the reference's precompile workload, constants fitted by BFGS
    Xc = (rng.standard_normal((5, 100)) * 2).astype(np.float32)
    yc = 2 * np.cos(Xc[4]) + Xc[1] ** 2 - 2
    tr = time.time()
    before = dict(kg.LAUNCHES)
    rec2 = equation_search(Xc, yc, binary_operators=["+", "-", "*", "/"],
                           unary_operators=["cos", "exp"], npopulations=16,
                           npop=100, ncycles_per_iteration=40, maxsize=18,
                           niterations=30, seed=0, early_stop_condition=1e-3,
                           verbosity=0)
    rb2 = rec2.best_loss()
    log(f"recovery with constants: {rb2.equation} loss {rb2.loss:.3g} after "
        f"{rec2.iterations} iterations, {time.time() - tr:.1f} s")
    assert kg.LAUNCHES["loss_grad"] - before["loss_grad"] == 9 * rec2.iterations
    assert rb2.loss < 1e-2, rec2
    # the same under L1 (mean absolute error), constants fitted by BFGS
    # through the any-loss kernels
    tr = time.time()
    key = "loss_grad:L1DistLoss"
    before = kg.LOSS_LAUNCHES.get(key, 0)
    rec3 = equation_search(Xc, yc, binary_operators=["+", "-", "*", "/"],
                           unary_operators=["cos", "exp"], npopulations=16,
                           npop=100, ncycles_per_iteration=40, maxsize=18,
                           niterations=30, seed=0, early_stop_condition=1e-3,
                           loss="L1DistLoss", verbosity=0)
    rb3 = rec3.best_loss()
    log(f"recovery under L1DistLoss: {rb3.equation} loss {rb3.loss:.3g} after "
        f"{rec3.iterations} iterations, {time.time() - tr:.1f} s")
    assert kg.LOSS_LAUNCHES.get(key, 0) - before == 9 * rec3.iterations
    assert rb3.loss < 1e-2, rec3

    # the reference's test_multi_output on the recovery fixture: both
    # targets at once on the normal X, each held to its threshold above
    # (the early stop waits for both outputs)
    Ym = np.stack([Xc[0] * Xc[0] - Xc[1] * Xc[2], yc]).astype(np.float32)
    tr = time.time()
    rec_m = equation_search(Xc, Ym, binary_operators=["+", "-", "*", "/"],
                            unary_operators=["cos", "exp"], npopulations=16,
                            npop=100, ncycles_per_iteration=40, maxsize=18,
                            niterations=30, seed=0, early_stop_condition=1e-6,
                            verbosity=0)
    rec_multi = dict(s=time.time() - tr, iterations=rec_m.iterations,
                     best=[rec_m.best_loss(j).loss for j in range(2)],
                     equations=[rec_m.best_loss(j).equation for j in range(2)])
    log(f"recovery with 2 outputs: {rec_multi['equations']} losses "
        f"{rec_multi['best']} after {rec_m.iterations} rounds, "
        f"{rec_multi['s']:.1f} s")
    assert rec_m.multi_output, rec_m
    assert rec_multi["best"][0] < 1e-6 and rec_multi["best"][1] < 1e-2, rec_m
    # to_callable on the card: B1's value mode, bit-equal to predict and to
    # B1's plain version on the same CUDA tensors
    from symbolicregression_jl_tpu_torch.utils.export import to_callable

    Xcd = torch.tensor(Xc, device=dev)
    for j in range(2):
        pick = rec_m.best(j)
        v0 = ke.LAUNCHES["value"]
        y_call = to_callable(pick.tree, rec_m.options)(Xcd)
        assert ke.LAUNCHES["value"] == v0 + 1, "to_callable did not launch B1"
        y_pred = rec_m.predict(Xc, output=j)
        tree_d = pick.tree.map(lambda x: x.to(dev).unsqueeze(0))
        y_plain, _ = ke.eval_trees_plain(tree_d, Xcd, rec_m.options.operators)
        assert torch.equal(y_call.cpu(), torch.from_numpy(y_pred)), j
        assert torch.equal(y_call, y_plain[0]), j
        # an array goes to the card by default
        y_arr = to_callable(pick.tree, rec_m.options)(Xc)
        assert y_arr.is_cuda and torch.equal(y_arr, y_call), j
    log("to_callable on the card: B1, bit-equal to predict and to B1's plain "
        "version for both outputs' best; an array runs on the card")

    # the reference's precision sweep (tests/test_precision.py
    # _tiny_search: loss < 1e-4 at float32, < 1e-2 below) on the card: the
    # count of recovered seeds over seeds 0-15 at float32 against the
    # reference's (9 of 16 on the CPU, tests/test_torch_recovery_rate.py),
    # then bfloat16 and float16 at every seed float32 recovers
    ref_recovered = 9
    rng_t = np.random.default_rng(0)
    Xt_ = (rng_t.standard_normal((2, 40)) * 2).astype("f4")
    tiny = {}

    def tiny_search(precision, seed):
        return equation_search(
            Xt_, Xt_[0] * Xt_[0], niterations=2, binary_operators=["+", "*"],
            npop=16, npopulations=2, ncycles_per_iteration=20,
            tournament_selection_n=6, precision=precision, verbosity=0,
            maxsize=10, seed=seed).best_loss().loss

    tr = time.time()
    tiny["float32"] = [tiny_search("float32", seed) for seed in range(16)]
    recovered = [i for i, v in enumerate(tiny["float32"]) if v < 1e-4]
    log(f"tiny search at float32, seeds 0-15: recovered at {len(recovered)} "
        f"of 16 (the reference: {ref_recovered} of 16), losses "
        f"{tiny['float32']}, {time.time() - tr:.1f} s")
    assert len(recovered) >= ref_recovered - 2, tiny
    for precision in ("bfloat16", "float16"):
        tr = time.time()
        tiny[precision] = {i: tiny_search(precision, i) for i in recovered}
        log(f"tiny search at {precision}, the {len(recovered)} seeds float32 "
            f"recovers: losses {tiny[precision]}, {time.time() - tr:.1f} s")
        assert all(v < 1e-2 for v in tiny[precision].values()), (precision,
                                                                 tiny)
    tiny["recovered_float32"] = len(recovered)
    tiny["reference_recovered_float32"] = ref_recovered

    # the reference's bodies with a user operator, a loss callable and
    # Nelder-Mead (tests/test_custom_operators.py:43, tests/test_mixed.py
    # :104 and :85, each with the reference's data, rng seed 0), and Newton
    # on the Nelder-Mead target; each must reach a loss below 1e-2 on the
    # user instantiations (the first two) or the registry's (the others)
    mixed = dict(niterations=14, npop=48, npopulations=4,
                 ncycles_per_iteration=150, maxsize=14, verbosity=0,
                 early_stop_condition=1e-6, binary_operators=["+", "-", "*"],
                 unary_operators=["cos"])
    user_bodies = {}

    def body(name, fn):
        zero_counts()
        tr = time.time()
        res_b = fn()
        best_b = res_b.best_loss()
        user_bodies[name] = dict(
            s=time.time() - tr, loss=best_b.loss, equation=best_b.equation,
            iterations=res_b.iterations,
            user_launches={**{f"eval:{k}": v for k, v in ke.USER_LAUNCHES.items()},
                           **{f"grad:{k}": v for k, v in kg.USER_LAUNCHES.items()}},
            registry_launches={**ke.LAUNCHES, **kg.LAUNCHES})
        log(f"reference body {name}: {best_b.equation} loss {best_b.loss:.3g} "
            f"after {res_b.iterations} iterations, "
            f"{user_bodies[name]['s']:.1f} s; user launches "
            f"{user_bodies[name]['user_launches']}")
        assert best_b.loss < 1e-2, (name, best_b)
        return res_b

    rng_b = np.random.default_rng(0)
    Xb = rng_b.standard_normal((2, 60)).astype(np.float32)
    yb = (np.sin(Xb[0]) + np.cos(Xb[0])) * 2.0
    body("test_search_with_custom_operator", lambda: equation_search(
        Xb, yb, niterations=4, binary_operators=["+", "*"],
        unary_operators=["op3c"], npop=24, npopulations=2,
        ncycles_per_iteration=40, maxsize=10, tournament_selection_n=6,
        verbosity=0, progress=False, seed=0, early_stop_condition=1e-6))
    assert user_bodies["test_search_with_custom_operator"]["user_launches"][
        "eval:fused"] > 0
    rng_b = np.random.default_rng(0)
    Xm_ = (rng_b.standard_normal((3, 80)) * 2).astype(np.float32)
    ym_ = Xm_[0] * Xm_[0] + 2.0 * np.cos(Xm_[2])
    res_l = body("test_custom_elementwise_loss", lambda: equation_search(
        Xm_, ym_, seed=8, loss=user_loss, **mixed))
    assert user_bodies["test_custom_elementwise_loss"]["user_launches"][
        "grad:loss_grad"] > 0
    rng_t2 = np.random.default_rng(95)
    Xt2 = (rng_t2.standard_normal((3, 80)) * 2).astype(np.float32)
    np.testing.assert_allclose(res_l.predict(Xt2),
                               Xt2[0] * Xt2[0] + 2.0 * np.cos(Xt2[2]),
                               atol=0.15)
    rng_b = np.random.default_rng(0)
    Xn = (rng_b.standard_normal((2, 80)) * 2).astype(np.float32)
    yn = 2.5382 * np.cos(Xn[1]) + Xn[0] * Xn[0] - 0.5
    for algo in ("NelderMead", "Newton"):
        body(f"test_nelder_mead_search ({algo})", lambda: equation_search(
            Xn, yn, seed=7, optimizer_algorithm=algo,
            optimizer_probability=0.3, **mixed))

    # the reference's bodies for this slice's three options: the custom
    # objective rewarding 0.5 * (x0 + x1) (tests/test_aux.py:140-160; the
    # objective through eval_tree and torch.where), per-island minibatches
    # (tests/test_api.py:292-301) and the float64 search of
    # tests/test_precision.py:39-61 (in this process: the port has no
    # global flag), each with the reference's data and thresholds
    def steer(tree, X_, y_, weights_, options_):
        pred, ok = interp.eval_tree(tree, X_, options_.operators)
        target = 0.5 * (X_[0] + X_[1])
        mse = torch.mean((pred - target) ** 2)
        return torch.where(ok, mse, torch.inf)

    rng_b = np.random.default_rng(0)
    Xs_ = rng_b.uniform(-2, 2, (2, 64)).astype(np.float32)
    body("test_custom_loss_function_steers_search", lambda: equation_search(
        Xs_, np.zeros(64, np.float32), binary_operators=["+", "*", "/"],
        loss_function=steer, npop=24, npopulations=4,
        ncycles_per_iteration=60, maxsize=12, verbosity=0, progress=False,
        seed=3, niterations=6))
    rng_b = np.random.default_rng(0)
    Xi_ = (rng_b.standard_normal((3, 60)) * 2).astype(np.float32)
    yi_ = Xi_[0] * Xi_[0] + 2.0 * np.cos(Xi_[2])
    tr = time.time()
    res_i = equation_search(
        Xi_, yi_, niterations=2, batching=True, batch_size=20,
        independent_island_batches=True, seed=0, runtests=False,
        binary_operators=["+", "-", "*"], unary_operators=["cos"], npop=24,
        npopulations=2, ncycles_per_iteration=30, maxsize=12,
        should_optimize_constants=False, verbosity=0, progress=False)
    assert len(res_i.frontier()) > 0 and np.isfinite(res_i.best_loss().loss)
    user_bodies["test_independent_island_batches"] = dict(
        s=time.time() - tr, loss=res_i.best_loss().loss,
        equation=res_i.best_loss().equation)
    log(f"reference body test_independent_island_batches: "
        f"{res_i.best_loss().equation} loss {res_i.best_loss().loss:.3g}, "
        f"{time.time() - tr:.1f} s")
    # the search of test_float64_in_subprocess (its data in float64) at
    # seeds 0-15: loss < 1e-8 at the reference's seed 0 (its assertion),
    # and recovered at no fewer seeds than the reference's float32 sweep
    # (9 of 16). A float64 search draws the reference's x64 stream (64-bit
    # draws, utils/rng.py draw_dtype), not the float32 search's, so the
    # seeds it recovers are not float32's
    rng_b = np.random.default_rng(0)
    X64 = rng_b.standard_normal((2, 40)) * 2
    tr = time.time()
    losses64, res_64 = {}, None
    for seed in range(16):
        res_64 = equation_search(
            X64, X64[0] * X64[0], niterations=2, binary_operators=["+", "*"],
            npop=16, npopulations=2, ncycles_per_iteration=20,
            tournament_selection_n=6, precision="float64", verbosity=0,
            progress=False, maxsize=10, seed=seed)
        losses64[seed] = res_64.best_loss().loss
    assert res_64.predict(X64).dtype == np.float64
    recovered64 = [s for s, v in losses64.items() if v < 1e-8]
    assert losses64[0] < 1e-8, losses64
    assert len(recovered64) >= ref_recovered, (losses64, recovered)
    user_bodies["test_float64_in_subprocess"] = dict(
        s=time.time() - tr, losses_by_seed=losses64, recovered=recovered64)
    log(f"reference body test_float64_in_subprocess (in process, float64 "
        f"data): losses by seed {losses64}; recovered at {len(recovered64)} "
        f"of 16 (float32: {len(recovered)}), seed 0 (the reference's) "
        f"{losses64[0]:.3g}, {time.time() - tr:.1f} s")

    # ---- 9. tenant-batched serving -------------------------------------------
    serve_report, serve_timing = phase_serving(dev, log, card)

    # ---- the record -----------------------------------------------------------
    replaces = {
        "fused": "symbolicregression_jl_tpu/ops/pallas_eval.py:1014 "
                    "(_postfix_call via eval_loss_trees_pallas :1257)",
        "value": "symbolicregression_jl_tpu/ops/pallas_eval.py:1014 "
                 "(_postfix_call via eval_trees_pallas :1059)",
        "fold": "symbolicregression_jl_tpu/models/mutate_device.py:469-582 "
                "(_const_fold_scan, a lax.scan, and simplify_tree; not a "
                "Pallas kernel)",
    }
    grad_src = "symbolicregression_jl_tpu/ops/pallas_grad.py:414 "
    replaces["loss_grad"] = grad_src + (
        "(make_loss_kernel(with_grad=True) :290, body _make_grad_kernel :64, "
        "via eval_loss_grad_pallas :235 and models/constant_opt.py:340)")
    replaces["loss"] = grad_src + (
        "(make_loss_kernel(with_grad=False) :290, via eval_loss_pallas :266 "
        "and models/constant_opt.py:347)")
    instr_src = "symbolicregression_jl_tpu/ops/pallas_eval.py:"
    replaces["instr"] = instr_src + (
        "1510 (_make_instr_kernel(packed=False) :737 via _eval_instr :1407)")
    replaces["instr_packed"] = instr_src + (
        "1490 (_make_instr_kernel(packed=True) :737 via _eval_instr :1407)")
    headline = {"fused": T_CYCLE, "value": T_CYCLE, "fold": T_CYCLE,
                "loss_grad": T_OPT, "loss": T_OPT * LS_STEPS,
                "instr": T_CYCLE, "instr_packed": T_CYCLE}
    sources = dict.fromkeys(("fused", "value", "fold"), "postfix_eval")
    sources.update(loss_grad="postfix_grad", loss="postfix_grad",
                   instr="instr_eval", instr_packed="instr_eval")
    kernels = []
    for name in ("fused", "value", "fold", "loss_grad", "loss", "instr",
                 "instr_packed"):
        h = timings[(name, headline[name])]
        src = sources[name]
        n_launch = (instr_runs[name]["launches"][name] if name in instr_runs
                    else launches[name])
        kernels.append({
            "name": f"{src}.{name}",
            "route": "cuda",
            "source": f"symbolicregression_jl_tpu_torch/csrc/{src}.cu",
            "replaces": replaces[name],
            "launches": n_launch,
            "max_abs_err": err[name],
            "max_rel_err": rel[name],
            "max_abs_err_44_operators": grid_err[name],
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": None,
            "shapes": [v for (n, _), v in timings.items() if n == name],
        })
    # the per-set form (one launch over several datasets): launches from
    # phase 9b's 64-tenant batch (the value mode's from 9c's weighted
    # batch, 4 tenants x 2 iterations of 50 cycles; per replayed cycle at
    # 64 tenants from 9b's weighted replay), errors and times from 9a
    engine = serve_report["engine"]
    launch_run = {n: f"9b: {engine['tenants']} tenants, 2 iterations of "
                     f"{engine['ncycles']} cycles" for n in
                  ("fused", "loss_grad", "loss")}
    launch_run["value"] = ("9c weighted: 4 tenants, 2 iterations of 50 "
                           "cycles; at 64 tenants (9b's weighted replay) "
                           f"{engine['weighted_launches_per_replay']['value']}"
                           " per replayed cycle")
    set_launch = {"fused": engine["launches"]["eval"].get("fused", 0),
                  "loss_grad": engine["launches"]["grad"].get("loss_grad", 0),
                  "loss": engine["launches"]["grad"].get("loss", 0),
                  "value": serve_report["variants"]["weighted"]["launches"][
                      "eval"].get("value", 0)}
    set_err = serve_report["kernels"]["max_abs_err"]
    for key, h in serve_timing.items():
        name, shape = key.split("@")
        kernels.append({
            "name": f"{sources[name]}.{name}@sets:{shape}",
            "route": "cuda",
            "source": f"symbolicregression_jl_tpu_torch/csrc/{sources[name]}.cu",
            "replaces": replaces[name] + " under the tenants vmap "
                        "(symbolicregression_jl_tpu/api.py:397-420, "
                        "serving/batched.py)",
            "launches": set_launch[name],
            "launches_per_iteration": set_launch[name] / 2,
            "launches_from": launch_run[name],
            "max_abs_err": set_err.get(name, 0.0),
            "bit_equal_share": {k: v for k, v in serve_report["kernels"][
                "bit_equal_share"].items() if k.startswith(
                    {"value": "B1", "fused": "B2", "loss_grad": "B3",
                     "loss": "B4"}[name])},
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": None,
            "single_set_launches_ms": h["single_set_launches_ms"],
            "sets": h["sets"], "per_set": h["per_set"], "reps": h["reps"],
        })
    for name, src, shape_key, (b_ms, b_by) in (
            ("fused", "postfix_eval", f"B2@{T_CYCLE}",
             bound(cycle, ke.MODE_FUSED, ROWS, "HuberLoss")),
            ("loss_grad", "postfix_grad", f"B3@{T_OPT}",
             grad_bound(opt_trees, 1, True, "HuberLoss")),
            ("loss", "postfix_grad", f"B4@{T_OPT * LS_STEPS}",
             grad_bound(opt_trees, LS_STEPS, False, "HuberLoss"))):
        err_key = {"fused": f"fused@{T_CYCLE}", "loss_grad": "gradient",
                   "loss": "loss_grad"}[name]
        kernels.append({
            "name": f"{src}.{name}@HuberLoss",
            "route": "cuda",
            "source": f"symbolicregression_jl_tpu_torch/csrc/{src}.cu",
            "includes": "symbolicregression_jl_tpu_torch/csrc/losses.cuh",
            "replaces": replaces[name] + ", loss_fn=huber_loss",
            "launches": huber_run["by_loss"][f"{name}:HuberLoss"],
            "max_abs_err": loss_err["HuberLoss"][err_key],
            "ms": loss_timing["HuberLoss"][shape_key],
            "plain_ms": huber_plain[name],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    for dt in ke.OTHER_STORAGE:
        sfx = ke.STORAGE[dt][1]
        precision = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                     torch.float64: "float64"}[dt]
        for name in ("value", "fold", "loss_grad", "loss", "instr",
                     "instr_packed"):
            h = storage_timing[(name + sfx, headline[name])]
            program = name if name.startswith("instr") else "auto"
            run = (slice_runs[f"float64:{program}"] if dt == torch.float64
                   else storage_runs[(precision, program)])
            src = sources[name]
            kernels.append({
                "name": f"{src}{sfx}.{name}",
                "route": "cuda",
                "source": f"symbolicregression_jl_tpu_torch/csrc/{src}.cu",
                "build": f"-DSR_STORAGE={ke.STORAGE[dt][0]} ({precision})",
                "replaces": replaces[name] + (
                    ", compute_dtype=bfloat16 (:497-500, :578-582, :778-788)"
                    if dt == torch.bfloat16 else
                    ", at float16 (the jnp interpreter's rounding)"
                    if dt == torch.float16 else
                    ", at float64 (which the reference routes to its jnp "
                    "interpreter: symbolicregression_jl_tpu/models/"
                    "options.py:958-975)"),
                "launches": run["storage"].get(name + sfx, 0),
                "max_abs_err": store_err[name + sfx],
                "ms": h["ms"], "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                "library_ms": None,
                "float32_ms": h["f32_ms"],
                "nvcc_s": nvcc_s[src + sfx],
            })
    # the gradient kernel's cotangent-seeded mode, at float32 and float64:
    # launches from phase 5h's custom-objective runs, errors from 3g
    cot_replaces = (
        "symbolicregression_jl_tpu/models/constant_opt.py:58-66 "
        "(_member_loss_fn's f_custom under jax.grad in _bfgs_single :83-140:"
        " the VJP of eval_tree through the jnp interpreter, not a Pallas "
        "kernel), in place of pallas_grad.py:414's seed")
    for sfx, run_key in (("", "loss_function"), ("_f64", "loss_function_f64")):
        h = cot_timing["vjp" + sfx]
        kernels.append({
            "name": f"postfix_grad{sfx}.vjp",
            "route": "cuda",
            "source": "symbolicregression_jl_tpu_torch/csrc/postfix_grad.cu",
            "build": ("-DSR_STORAGE=3 (float64)" if sfx else "float32"),
            "replaces": cot_replaces,
            "launches": slice_runs[run_key]["vjp"].get("vjp" + sfx, 0),
            "max_abs_err": store_err["vjp" + sfx],
            "vs_interpreter_vjp": cot_report[sfx or "_f32"][
                "vs_interpreter_rel_to_yardstick"],
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": None, "loss_grad_ms": h["loss_grad_ms"],
        })
    # the user instantiations (the generated headers' builds): launches
    # from phase 5g's runs, errors and times from phase 3f
    user_src = {"fused": ("postfix_eval", h_loss), "value": ("postfix_eval", h_ops),
                "fold": ("postfix_eval", h_ops),
                "loss_grad": ("postfix_grad", h_loss),
                "loss": ("postfix_grad", h_loss),
                "instr": ("instr_eval", h_ops),
                "instr_packed": ("instr_eval", h_ops)}
    user_launch = {"fused": user_runs["BFGS"]["user_eval"]["fused"],
                   "fold": user_runs["BFGS"]["user_eval"]["fold"],
                   "loss_grad": user_runs["BFGS"]["user_grad"]["loss_grad"],
                   "loss": user_runs["BFGS"]["user_grad"]["loss"],
                   "value": user_runs["weighted"]["user_eval"]["value"],
                   "instr": user_runs["instr"]["user_instr"]["instr"],
                   "instr_packed": user_runs["instr_packed"]["user_instr"][
                       "instr_packed"]}
    user_hook = (", with user operators: the full instantiation's dispatch "
                 "on operators.kernel_unary_fns / kernel_binary_fns "
                 "(pallas_eval.py:433-434, :767-768; pallas_grad.py:80-81)")
    loss_hook = (" and a loss callable (loss_fn: pallas_eval.py:1257, "
                 "pallas_grad.py:183-191, :290)")
    for name, (src, hdr) in user_src.items():
        t = user_report["timing"][name]
        # B4's loss is B3's in every bit, B3's against its mirror
        err_key = {"loss_grad": "gradient", "loss": "loss_grad"}.get(name, name)
        kernels.append({
            "name": f"{src}_user.{name}",
            "route": "cuda",
            "source": f"symbolicregression_jl_tpu_torch/csrc/{src}.cu",
            "build": f"-DSR_USER_OPS, header {hdr.key} generated by "
                     "symbolicregression_jl_tpu_torch/ops/user_ops.py",
            "replaces": replaces[name] + user_hook + (
                loss_hook if hdr is h_loss else ""),
            "launches": user_launch[name],
            "max_abs_err": user_report["max_abs_err"][err_key],
            "bit_equal_share": user_report["bit_equal_share"][err_key],
            "ms": t["user_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "registry_full_ms": t["registry_ms"],
            "registry_on_user_build_ms": t["registry_user_build_ms"],
            "nvcc_s": nvcc_s[f"{src}_u{hdr.key}"],
        })
    # the threefry kernel, one entry per mode: launches from the main
    # path's run (phase 5), errors and times from phase 1b
    rng_replaces = (
        "no Pallas kernel: XLA's threefry2x32 lowering (jax/_src/prng.py "
        "threefry_2x32) behind every jax.random split and draw of the "
        "search (symbolicregression_jl_tpu/models/mutate_device.py:51-74, "
        "evolve.py:181-346,416-471,799-820, population.py:85-140, "
        "fitness.py:552, constant_opt.py:445-460, parallel/migration.py:"
        "104-121)")
    for mode, t in rng_report["timings"].items():
        at_shape = f"{mode} at {t['keys']} x {t['per_key']}"
        kernels.append({
            "name": f"threefry.{mode}",
            "route": "cuda",
            "source": "symbolicregression_jl_tpu_torch/csrc/threefry.cu",
            "replaces": rng_replaces,
            "launches": rng_launches[mode],
            "launches_per_replayed_cycle": graph_report["threefry_per_cycle"].get(
                mode, 0.0),
            "max_abs_err": rng_report["max_abs_err"][at_shape],
            "bit_equal_share": rng_report["bit_equal_share"][at_shape],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "plain_on": "host CPU",
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": [t["keys"], t["per_key"]],
        })
    # the draw plans, one entry per plan: launches from the main
    # path's run (phase 5; the minibatch plan's from phase 5h(c)), errors
    # and times from phase 1b
    plan_replaces = {
        "propose": "evolve.py:403-471 (_propose_children's splits, the "
                   "coin and acceptance draws) and population.py:106-140 "
                   "(tournament_winner)",
        "mutate": "evolve.py:248-300 (_mutate_member) with every branch of "
                  "mutate_device.py:51-460, gen_random_tree_fixed_size's "
                  "loop (:391-430) included",
        "crossover": "evolve.py:329-346 (_crossover_pair), "
                     "mutate_device.py crossover_trees",
        "random_tree_draws": "population.py:85 (init_population) -> "
                             "mutate_device.py:391-430",
        "minibatch": "evolve.py:795-806 (the minibatch chain), "
                     "fitness.py:552 (sample_batch_idx)",
    }
    # the float64 plans' launches: phase 5h(a)'s and 5h(b)'s float64
    # searches (each run's counts zeroed before it)
    f64_runs = [r for k, r in slice_runs.items()
                if k.startswith("float64:") or k == "loss_function_f64"]
    for name, t in plan_report.items():
        base = name.removesuffix(F64_SUFFIX)
        if name != base:
            launches = sum(r["plans"].get(base, 0) for r in f64_runs)
        elif name == "minibatch":
            launches = slice_runs["island_batches"]["plans"].get(name, 0)
        else:
            launches = plan_launches.get(name, 0)
        assert launches > 0, f"plan {name} did not launch on its path"
        kernels.append({
            "name": f"threefry.plan.{name}",
            "route": "cuda",
            "source": "symbolicregression_jl_tpu_torch/csrc/threefry.cu",
            "replaces": ("no Pallas kernel: XLA's threefry2x32 lowering "
                         "behind the jax.random splits and draws of "
                         "symbolicregression_jl_tpu/models/"
                         + plan_replaces[base]),
            "launches": launches,
            "launches_per_replayed_cycle": None if name != base else
            graph_report["plans_per_cycle"].get(name, 0.0),
            "max_abs_err": t["max_abs_err"],
            "bit_equal_share": t["bit_equal_share"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "plain_on": "host CPU",
            "per_call_ms": t["per_call_ms"],
            "per_call_launches": t["per_call_launches"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": [t["keys"]] + t["axes"],
        })
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels, "card": card, "host": cpu,
                      "threefry_plans": plan_report,
                      "threefry": {k: v for k, v in rng_report.items()
                                   if k != "timings"},
                      "main_path": {"s_per_iteration": [s for s, _ in per_iter],
                                    "optimize_s_per_iteration": opt_s,
                                    "ncycles": args.ncycles,
                                    "peak_bytes": peak},
                      "instr_path": {k: {f: v[f] for f in ("s", "s_per_iteration",
                                                           "launches", "peak_bytes")}
                                     for k, v in instr_runs.items()},
                      "main_path_by_loss": main_by_loss,
                      "huber_path": huber_run, "loss_timing": loss_timing,
                      "loss_err": loss_err, "huber_plain_ms": huber_plain,
                      "cycle_ms": cycle_ms, "cycle_profile": cycle_profile,
                      "cycle_graph": graph_report,
                      "main_path_graph": main_graph_stats,
                      "optimize_pass": pass_profile,
                      "long_programs": long_report,
                      "build_s": build_s, "nvcc_s": nvcc_s,
                      "storage": storage_report,
                      "storage_timing": {f"{k[0]}@{k[1]}": v for k, v in
                                         storage_timing.items()},
                      "storage_paths": {f"{k[0]}:{k[1]}": v for k, v in
                                        storage_runs.items()},
                      "tiny_search": tiny, "front_door": door,
                      "recovery_multi": rec_multi,
                      "user_kernels": user_report, "user_paths": user_runs,
                      "user_bodies": user_bodies,
                      "cotangent": {"check": cot_report, "timing": cot_timing},
                      "slice_paths": slice_runs,
                      "serving": serve_report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
