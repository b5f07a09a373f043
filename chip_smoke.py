"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--ncycles N] [--niterations N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. card and build: the card's name and power limit; the CUDA kernels
   ``symbolicregression_jl_tpu_torch/csrc/postfix_eval.cu`` (scoring),
   ``csrc/postfix_grad.cu`` (constant optimisation) and
   ``csrc/instr_eval.cu`` (instruction programs) built with nvcc for each
   working dtype (float32, and the bfloat16 and float16 storage builds,
   ``-DSR_STORAGE``), nine processes started together, each with its nvcc
   seconds and ptxas's register / shared-memory / spill lines;
2. scoring kernels vs plain PyTorch versions on the card at the main
   path's shapes (Feynman-I.6.2a, 2048 rows; 5,376 trees = one cycle's
   children at 64 islands x 1000, 64,000 trees = one rescore), poisoning
   trees, bare leaves and a unary chain included: the postfix kernel in
   every mode (value and slot modes bit-equal to their plain versions; two
   launches of the fused mode give the same bits), and the
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
   operators, the hand-written digamma against torch.digamma, a short
   search over the operators the earlier slices did not carry, and a
   short search at maxsize 110 (max_len 112) with the default BFGS;
3c. every kernel at max_len 512, 1,024 and 2,048 (the narrow routes,
   their stacks, slot values or results in shared or global memory) on
   2,048 rows, random and deep programs, poisoning and invalid programs:
   B1 and the slot mode bit-equal to their plain versions, B2 within rtol
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
3e. the bfloat16 and float16 builds: B1, the slot mode, B5 and B6 at
   5,376 and 64,000 trees, B3 at 26,880 instances and B4 at 26,880 and
   215,040, x 2,048 rows (unweighted and with zero-weight rows), then every
   kernel at max_len 512 and 1,024 (the narrow routes): bit-equal to the
   plain versions (which round every value as the kernels do), B5/B6 to
   B1, B3's loss to B4's, two launches the same bits, programs that
   overflow only at the storage rounding and invalid programs poisoned;
4. timing of every kernel alone (its launches queued behind a spin on the
   card, CUDA events), beside its plain version and its bound (bytes over
   3.35 TB/s, f32 operations over 67 TFLOP/s); the launch layout of the
   scoring, gradient, loss-only and instruction-program kernels (work
   items per tree, rows or candidates per lane, warps per block, resident
   blocks per SM) and their ptxas lines; the instruction-program wrappers'
   host milliseconds per call; B2, B3 and B4 under L1, Huber and LogCosh
   beside L2, and the fused scoring route against the value route (B1,
   the loss in PyTorch, ``aggregate_loss``) at 5,376 and 64,000 trees;
   every bfloat16 and float16 build beside float32's (bound with X,
   constants and outputs at 2 bytes), and the value route of a scoring
   call at those dtypes;
5. the main path: ``equation_search`` at 64 islands x 1000, maxsize 20,
   ``+ - * /`` with ``cos exp``, L2 loss, default constant optimisation
   (BFGS), then ``predict``; every cycle is a replay of one captured CUDA
   graph (``models/cycle_graph.py``: one capture, niterations x ncycles
   replays, its pool's device memory printed beside the peak); the launch
   counts (a replay adds what its capture counted) are zeroed just before
   and read just after, and each iteration's optimisation pass is timed; then
   the same search with ``kernel_program="instr"`` and ``"instr_packed"``
   (one iteration each, same seed: their halls of fame must be
   bit-equal), the counts zeroed before and read after each; then a short
   search whose every batch must hold valid programs only; then the
   search at the same widths under ``loss="HuberLoss"`` (1 iteration of
   100 cycles, default BFGS): every scoring call through the fused mode's
   any-loss instantiation, B3 and B4 under Huber, no value-mode call;
5e. the search at the same widths at ``precision="bfloat16"``, then
   ``"float16"`` (1 iteration of 100 cycles; then 20 cycles on each
   instruction program): every launch of that dtype's builds (the value
   mode, B5 or B6 for every scoring call, the slot mode, B3 and B4), no
   fused-mode launch and no float32 build launched;
6. the cycle alone at the same widths: milliseconds per eager cycle with
   the constant fold through the slot-values kernel and through its plain
   version (interleaved, twice each), and a profile of 20 eager cycles
   without init, simplify or rescore (device kernels per cycle, idle
   share, host synchronisations per cycle by issuing operator: there must
   be none, and no copy from or to host memory); then the captured cycle
   against the eager one: bit-equal states, generators and launch counts
   after 20 cycles from one state and seed, milliseconds per cycle A B B A
   over 50 cycles each, and a profile of 20 replayed cycles (device
   kernels per cycle, idle share), with replays, captures, capture seconds
   and the graph pool's memory; the scoring wrapper alone, and the
   instruction programs' scoring call, must make no host wait;
7. the optimisation pass alone on that 64 x 1000 state: milliseconds per
   pass, and a profile of one pass (device kernels, the kernels' share);
8. recovery on the card: ``x0*x0 - x1*x2`` without constant optimisation,
   ``2*cos(x4) + x1^2 - 2`` with it, under L2 and under ``L1DistLoss``;
   the reference's precision sweep (``tests/test_precision.py``
   ``_tiny_search``) at float32 over seeds 0-15, its count of recovered
   seeds beside the reference's (at least the reference's less 2), then
   bfloat16 and float16 at every seed float32 recovers.

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
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ROWS = 2048
T_CYCLE = 64 * 84  # children per cycle: 64 islands x B=84
T_RESCORE = 64 * 1000
T_OPT = 64 * 3 * 140  # BFGS instances: islands x starts x round(1000 * 0.14)
LS_STEPS = 8  # line-search candidates per instance


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
    from symbolicregression_jl_tpu_torch.models.mutate_device import (
        gen_random_tree_fixed_size,
    )
    from symbolicregression_jl_tpu_torch.models.trees import (
        BIN, CONST, VAR, TreeBatch, UNA, encode_tree, parse_expression, stack_trees,
    )
    from symbolicregression_jl_tpu_torch.ops import kernel_eval as ke
    from symbolicregression_jl_tpu_torch.ops import kernel_grad as kg
    from symbolicregression_jl_tpu_torch.ops import kernel_instr as ki
    from symbolicregression_jl_tpu_torch.ops import losses as tlosses
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_REGISTRY, UNARY_REGISTRY, make_operator_set,
    )
    from symbolicregression_jl_tpu_torch.utils.rng import make_generator

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
    # float16: nine libraries), all started together
    builds = [(m, d) for d in ke.STORAGE for m in (ke, kg, ki)]
    with ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(m.build_library, True, d) for m, d in builds]:
            f.result()
    build_s = time.time() - tb
    log(f"build: nvcc {build_s:.1f} s for the three sources x three dtypes")
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

    # ---- 2. scoring kernel vs plain at the main path's shapes -------------
    ops = make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    X_np, y_np = feynman_data()
    X = torch.tensor(X_np, device=dev)
    y = torch.tensor(y_np, device=dev)
    gen = make_generator(1, dev)
    sizes = torch.randint(3, 21, (T_RESCORE,), generator=gen, device=dev)
    trees = gen_random_tree_fixed_size(gen, sizes, 1, ops, 24, dev)
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
    err = {"value": 0.0, "fused": 0.0, "slots": 0.0}
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
        assert_bits("slot mode vs plain", sk[fin], sp[fin])
        note("slots", sk[fin], sp[fin])

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
    for tb_ in (cycle, trees):
        n_ok = check_instr(tb_, X, ops, f"T={tb_.length.shape[0]}")
        log(f"instr kernels T={tb_.length.shape[0]}: ok equal and values "
            f"bit-equal to the postfix value mode ({n_ok} trees not poisoned)")
    torch.cuda.synchronize()
    log(f"kernel vs plain: agree at T={T_CYCLE} and T={T_RESCORE} x {ROWS} "
        f"rows; max abs err {err}; max rel err {rel}")

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
    long_trees = gen_random_tree_fixed_size(
        gen, torch.randint(3, 110, (T_LONG,), generator=gen, device=dev), 1,
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
    all_ops = make_operator_set(sorted(set(BINARY_REGISTRY) - {"pow"}),
                                sorted(UNARY_REGISTRY))
    T_GRID = 4096
    ggen = make_generator(3, dev)
    g_trees = gen_random_tree_fixed_size(
        ggen, torch.randint(1, 21, (T_GRID,), generator=ggen, device=dev), 3,
        all_ops, 24, dev)
    Xg = torch.randn((3, ROWS), generator=ggen, device=dev) * 1.5
    yg = torch.randn(ROWS, generator=ggen, device=dev)
    grid_err = dict.fromkeys(("value", "fused", "slots", "loss_grad", "loss",
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
        f"of the row-sum yardstick, {n_over} whose row sum overflows); max "
        f"abs err {grid_err}; digamma vs torch.digamma max abs err "
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
    assert res_s.candidates and np.isfinite(res_s.best_loss().loss)
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
    assert res_l.candidates and np.isfinite(res_l.best_loss().loss)
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
        big = gen_random_tree_fixed_size(
            gen, torch.randint(1, L_big - 2, (T_big,), generator=gen,
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
        assert_bits(f"max_len {L_big}, slot mode vs plain", sk[fin], sp[fin])
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
        layouts = dict(
            value=ke.launch_plan(T_all, L_big, 1, ROWS, ke.MODE_VALUE, False, 0),
            loss_grad=kg.grad_plan(T_all, 1, L_big, False),
            loss=kg.loss_plan(T_all, LS_STEPS, L_big, False),
            instr=ki.launch_plan(T_all, L_big, 1, ROWS, False, False, 0))
        long_report[L_big] = {k: v._asdict() for k, v in layouts.items()}
        log(f"max_len {L_big}: {T_all} trees ({int(okk.sum())} not poisoned, "
            f"{nb} invalid) x {ROWS} rows: value and slot modes bit-equal to "
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
    assert res_509.candidates and np.isfinite(res_509.best_loss().loss)
    assert after_all["loss_grad"] - before_all["loss_grad"] == 9 * 2
    assert after_all["loss"] - before_all["loss"] == 8 * 2
    assert after_all["fused"] - before_all["fused"] >= 2 * 30
    assert after_all["slots"] - before_all["slots"] >= 2 * 30
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
        """The bit patterns of 2- or 4-byte floats."""
        return t.contiguous().view(torch.int16 if t.element_size() == 2
                                   else torch.int32)

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
            d = (got[fin].float() - ref[fin].float()).abs()
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
    for dt in ke.NARROW_STORAGE:
        sfx = ke.STORAGE[dt][1]
        rep = storage_report[sfx[1:]] = {}
        Xs, ys, X1s = X.to(dt), y.to(dt), X1.to(dt)
        # the overflow at the rounding poisons at this dtype alone
        ok32 = ke.eval_trees(over, X, ops)[1]
        okst = ke.eval_trees(over, Xs, ops)[1]
        assert bool(ok32.all()) and not bool(okst[0 if sfx == "_bf16" else 1])
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
            assert int((~okk).sum()) >= nf + 3, "poisoning trees were not poisoned"
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
            big = gen_random_tree_fixed_size(
                gen, torch.randint(1, L_big - 2, (T_big,), generator=gen,
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
        log(f"storage {sfx[1:]}: B1, slots, B5, B6 at {T_CYCLE} and "
            f"{T_RESCORE} trees, B3 at {T_OPT} and B4 at {T_OPT} x 1 / "
            f"{T_OPT * LS_STEPS} instances x {ROWS} rows (unweighted and "
            f"weighted), every kernel at max_len 512 and 1,024: bit-equal to "
            f"the plain versions (B4 on the line search's distinct candidates "
            f"too), B5/B6 to B1, B3's loss to B4's, two "
            f"launches the same bits, overflow at the rounding and invalid "
            f"programs poisoned; {rep}")
    log(f"storage builds checked in {time.time() - tstore:.1f} s")

    # ---- 4. timing ----------------------------------------------------------
    n_op_nodes = lambda tb_: int((tb_.kind >= UNA).sum())

    # operations per row of each timed loss: (its elementwise loss, its
    # seed), from csrc/losses.cuh, a transcendental function counted as one
    loss_ops = {"L2DistLoss": (2, 2), "L1DistLoss": (2, 2),
                "HuberLoss": (5, 7), "LogCoshLoss": (7, 10)}

    def bound(tb_, mode, nrows, loss_name="L2DistLoss", elem=4):
        """``elem``: bytes of an element of X, a constant and an output
        value (2 for the bfloat16 and float16 builds)."""
        T, L = tb_.kind.shape
        nfeat = X.shape[0] if mode != ke.MODE_SLOTS else 1
        # four 4-byte entries and a constant per live slot (opcode, feature,
        # two operand slots, constant: the compact encoding of a program),
        # plus each tree's length and its place in the length sort
        bytes_in = (nfeat * nrows * elem + int(tb_.length.sum()) * (4 * 4 + elem)
                    + T * 8 * 2)
        if mode == ke.MODE_FUSED:
            bytes_in += nrows * 4
        bytes_out = T * 4 + {ke.MODE_VALUE: T * nrows * elem,
                             ke.MODE_FUSED: T * 4,
                             ke.MODE_SLOTS: T * L * elem}[mode]
        ops_ = n_op_nodes(tb_) * nrows + ((loss_ops[loss_name][0] + 1) * T
                                          * nrows if mode == ke.MODE_FUSED
                                          else 0)
        t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / F32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    plain_fn = {
        ke.MODE_VALUE: lambda tb_: [ke.eval_trees_plain(tb_[i:i + 8192], X, ops)
                                    for i in range(0, tb_.length.shape[0], 8192)],
        ke.MODE_FUSED: lambda tb_: [ke.eval_loss_trees_plain(tb_[i:i + 8192], X, y, ops)
                                       for i in range(0, tb_.length.shape[0], 8192)],
        ke.MODE_SLOTS: lambda tb_: [ke.eval_slot_values_plain(tb_[i:i + 8192], X1, ops)
                                    for i in range(0, tb_.length.shape[0], 8192)],
    }
    timings = {}
    for mode in (ke.MODE_FUSED, ke.MODE_VALUE, ke.MODE_SLOTS):
        name = ke.MODE_NAMES[mode]
        for tb_ in (cycle, trees):
            T = tb_.length.shape[0]
            Xm = X1 if mode == ke.MODE_SLOTS else X
            ym = y if mode == ke.MODE_FUSED else None
            prep = ke.prepare_launch(tb_, Xm, ym, ops, mode)
            ms = device_ms(lambda: ke.run_prepared(prep), 50)
            wrap = {ke.MODE_VALUE: lambda: ke.eval_trees(tb_, X, ops),
                    ke.MODE_FUSED: lambda: ke.eval_loss_trees(tb_, X, y, ops),
                    ke.MODE_SLOTS: lambda: ke.eval_slot_values(tb_, X1, ops)}[mode]
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

    def grad_bound(tb_, reps, with_grad, loss_name="L2DistLoss", elem=4):
        """Inputs read once: X, y and wn, the three int64 tree fields of
        live slots (kind, op, feature), each tree's length and sort
        position, the constants of live slots (X, y and the constants of
        ``elem`` bytes); outputs: loss and poison flag per instance, and
        the gradient row.
        Operations per row: each operator node forward (and backward with
        the gradient), the elementwise loss and 2 to weigh and add it (the
        seed and 1 to weigh it): 4 (6) for L2."""
        elem_ops, seed_ops = loss_ops[loss_name]
        T, L = tb_.kind.shape
        N = T * reps
        live = int(tb_.length.sum())
        bytes_in = (X.shape[0] * ROWS * elem + ROWS * (elem + 4)
                    + live * 3 * 8 + T * 8 * 2 + reps * live * elem)
        bytes_out = N * 4 * 2 + (N * L * 4 if with_grad else 0)
        ops_ = (reps * n_op_nodes(tb_) * ROWS * (2 if with_grad else 1)
                + N * ROWS * (elem_ops + 2 + (seed_ops + 1 if with_grad else 0)))
        t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / F32_OPS_PER_S * 1e3
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
    for dt in ke.NARROW_STORAGE:
        sfx = ke.STORAGE[dt][1]
        Xs, ys, X1s = X.to(dt), y.to(dt), X1.to(dt)
        for tb_ in (cycle_s, trees_s):
            T = tb_.length.shape[0]
            chunks = lambda fn: [fn(tb_[i:i + 8192]) for i in range(0, T, 8192)]
            cases = [
                ("value", ke.prepare_launch(tb_, Xs, None, ops, ke.MODE_VALUE),
                 ke.run_prepared,
                 lambda: chunks(lambda c: ke.eval_trees_plain(c, Xs, ops)),
                 bound(tb_, ke.MODE_VALUE, ROWS, elem=2)),
                ("slots", ke.prepare_launch(tb_, X1s, None, ops, ke.MODE_SLOTS),
                 ke.run_prepared,
                 lambda: chunks(lambda c: ke.eval_slot_values_plain(c, X1s, ops)),
                 bound(tb_, ke.MODE_SLOTS, 1, elem=2))]
            for name, packed in (("instr", False), ("instr_packed", True)):
                cases.append((name, ki.prepare_launch(tb_, Xs, ops, packed),
                              ki.run_prepared,
                              lambda packed=packed: chunks(
                                  lambda c: ki.eval_trees_instr_plain(
                                      c, Xs, ops, packed)),
                              bound(tb_, ke.MODE_VALUE, ROWS, elem=2)))
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
            b_ms, b_by = grad_bound(opt_s, reps, with_grad, elem=2)
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
    # phase 3e's and this section's 2-byte tensors and the closures that
    # hold them (about 0.8 GB) go before the main path, whose peak memory
    # is read below
    del (prep_, cases, chunks, plain, raw, rep_s, Xs, ys, X1s, head, front,
         over, cycle_s, trees_s, opt_s, tb_, big, big_cv, cand, yk, okk, yp,
         okp, outs, sk, oks, sp, okps, fin, yi, oki, yip, okip, ym, bad_m,
         raw3, l3, g3, b3, l3b, g3b, b3b, ok3, lm, gm, okm, raw4, l4, b4,
         ok32, okst)

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

    def on_iteration(it, cands):
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
        ke.LOSS_LAUNCHES.clear()
        kg.LOSS_LAUNCHES.clear()

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
    assert res.candidates, "empty hall of fame"
    assert len(per_iter) == args.niterations
    assert all(np.isfinite(b) for _, b in per_iter), per_iter
    assert per_iter[-1][1] <= per_iter[0][1], per_iter
    assert launches["fused"] >= args.niterations * args.ncycles, launches
    # one BFGS pass per iteration: the start and 8 steps (gradient), 8 line
    # searches (loss only)
    assert launches["loss_grad"] == 9 * args.niterations, launches
    assert launches["loss"] == 8 * args.niterations, launches
    assert len(opt_s) == args.niterations, opt_s
    assert all(v > 0 for v in launches.values()), launches
    assert pred.shape == (ROWS,)
    best = res.best()
    log(f"main path: best {best.equation} loss {best.loss:.6g}; "
        f"s/iteration {[round(s, 3) for s, _ in per_iter]}, optimisation pass "
        f"s/iteration {[round(s, 3) for s in opt_s]}")

    # ---- 5b. the instruction programs at full width --------------------------
    instr_runs = {}
    for program in ("instr", "instr_packed"):
        log(f"instr path: equation_search kernel_program={program!r} 64 x 1000, "
            f"{ROWS} rows, maxsize 20, default constant optimisation, 1 "
            "iteration of 550 cycles")
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t_i = time.time()
        it_s = []
        res_i = equation_search(
            X_np, y_np, niterations=1, ncycles_per_iteration=550, seed=0,
            kernel_program=program,
            on_iteration=lambda it, c: it_s.append(time.time() - t_i), **cfg)
        torch.cuda.synchronize()
        run = dict(s=time.time() - t_i, s_per_iteration=it_s,
                   launches={**ke.LAUNCHES, **kg.LAUNCHES, **ki.LAUNCHES},
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   hof=[(c.complexity, c.loss, c.equation)
                        for c in res_i.candidates])
        instr_runs[program] = run
        lc = run["launches"]
        other = "instr" if program == "instr_packed" else "instr_packed"
        # every scoring call: 1 at init, 1 per cycle, 1 rescore
        assert lc[program] == 1 + 550 + 1, lc
        assert lc[other] == 0 and lc["fused"] == 0 and lc["value"] == 0, lc
        assert lc["loss_grad"] == 9 and lc["loss"] == 8, lc
        assert res_i.candidates and np.isfinite(res_i.best_loss().loss)
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

    ke.prepare_launch, kg.stage_launch = prepare_checked, stage_checked
    cg.clear_cache()
    try:
        equation_search(X_np, y_np, niterations=1, ncycles_per_iteration=30,
                        seed=1, **cfg)
    finally:
        ke.prepare_launch, kg.stage_launch = prepare, stage
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
    assert huber_run["launches"]["slots"] > 0, huber_run
    assert not any(ki.LAUNCHES.values()), ki.LAUNCHES
    assert res_h.candidates and np.isfinite(res_h.best_loss().loss)
    log(f"Huber path: {huber_run['s']:.1f} s, launches {huber_run['launches']}, "
        f"by loss {huber_run['by_loss']}; best {res_h.best_loss().equation} "
        f"loss {res_h.best_loss().loss:.6g}")

    # ---- 5e. the north-star search at bfloat16 and float16 ----------------------
    # the same widths at precision="bfloat16", then "float16": 1 iteration of
    # 100 cycles on the default program, then 20 cycles on each instruction
    # program. Every launch must be of that dtype's builds: the value mode
    # (or B5 / B6) for every scoring call, never the fused mode (float32
    # only), the slot-values mode for the fold, B3 / B4 for BFGS.
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
                                    **cfg)
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
                elif k == f"slots{sfx}":
                    assert v >= n_cyc + 1, run
                else:
                    assert v == 0, (k, run)
            assert res_s.candidates and np.isfinite(res_s.best_loss().loss)
            assert res_s.state.global_hof.losses.dtype == {
                "bfloat16": torch.bfloat16, "float16": torch.float16}[precision]
            log(f"{precision} path ({program}): {run['s']:.1f} s for 1 iteration "
                f"of {n_cyc} cycles, storage launches "
                f"{ {k: v for k, v in run['storage'].items() if v} }, no "
                f"float32 launch; best {run['equation']} loss {run['best']:.6g}")

    # ---- 6. the cycle alone ---------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from symbolicregression_jl_tpu_torch.api import _baseline_loss
    from symbolicregression_jl_tpu_torch.models.evolve import (
        init_island_state, s_r_cycle_islands,
    )
    from symbolicregression_jl_tpu_torch.models.options import make_options
    from symbolicregression_jl_tpu_torch.tools.kernel_breakdown import (
        sync_counts,
    )

    opts = make_options(**cfg)
    base = _baseline_loss(X, y, None, opts)
    cgen = make_generator(2, dev)
    st = init_island_state(cgen, opts, 1, X, y, None, base, 64)

    def cycles(n, loop=s_r_cycle_islands):
        nonlocal st
        torch.cuda.synchronize()
        tc = time.time()
        st = loop(cgen, st, opts.maxsize, X, y, None, base, opts, ncycles=n)
        torch.cuda.synchronize()
        return (time.time() - tc) * 1e3 / n

    cycles(5)  # warm-up
    kernel_fold = ke.eval_slot_values
    cycle_ms = {"kernel_fold": [], "plain_fold": []}
    for variant in ("kernel_fold", "plain_fold", "kernel_fold", "plain_fold"):
        ke.eval_slot_values = (kernel_fold if variant == "kernel_fold"
                               else ke.eval_slot_values_plain)
        try:
            cycle_ms[variant].append(cycles(20))
        finally:
            ke.eval_slot_values = kernel_fold
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
    bit_gens = [make_generator(11, dev), make_generator(11, dev)]
    zero_counts()
    eager20 = s_r_cycle_islands(bit_gens[0], st0, opts.maxsize, X, y, None,
                                base, opts, ncycles=20)
    eager_counts = [dict(c) for c in cg.LAUNCH_COUNTERS]
    zero_counts()
    graph20 = graph_cycles(bit_gens[1], st0, opts.maxsize, X, y, None, base,
                           opts, ncycles=20)
    graph_counts = [dict(c) for c in cg.LAUNCH_COUNTERS]
    torch.cuda.synchronize()
    leaves = list(zip(cg._leaves(eager20), cg._leaves(graph20)))
    n_differ = sum(not torch.equal(a, b) for a, b in leaves)
    assert n_differ == 0, f"{n_differ} of {len(leaves)} state fields differ"
    assert torch.equal(bit_gens[0].get_state(), bit_gens[1].get_state())
    assert eager_counts == graph_counts, (eager_counts, graph_counts)
    log(f"cycle graph: 20 replayed cycles bit-equal to 20 eager cycles from "
        f"one state (all {len(leaves)} IslandState fields and the generator), "
        f"launch counts equal {graph_counts[:3]}")
    del eager20, graph20, st0
    graph_ms = {"eager": [], "captured": []}
    n_ab = 50
    for variant in ("eager", "captured", "captured", "eager"):
        graph_ms[variant].append(cycles(
            n_ab, s_r_cycle_islands if variant == "eager" else graph_cycles))
        log(f"cycle A/B: {variant}: {graph_ms[variant][-1]:.3f} ms per cycle "
            f"({n_ab} cycles, host clock)")
    (cyc_graph,) = [g for g in cg._CACHE.values() if g.X.shape == X.shape
                    and g.options == opts]
    prof, gprof_ms = cycle_profile_of(prof_cycles, graph_cycles)
    gka, _, gbusy_ms, g_kernels = device_busy(prof)
    log(gka.table(sort_by=dev_attr, row_limit=12))
    g_calls, _ = sync_counts(prof)
    graph_report = dict(
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
    # the scoring wrapper alone: the cycle's fused scoring and slot-values
    # calls must not wait for the card
    Xs1 = X[:, :1].contiguous()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ke.eval_loss_trees(cycle, X, y, ops)
            ke.eval_slot_values(cycle, Xs1, ops)
    wrapper_calls, wrapper_ops = sync_counts(prof)
    cycle_profile["scoring_wrapper_host_calls"] = dict(wrapper_calls)
    log(f"scoring wrapper alone (10 fused + 10 slot-values calls at "
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
        st = optimize_islands_constants(cgen, st, X, y, None, base, opts)
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

    # ---- the record -----------------------------------------------------------
    replaces = {
        "fused": "symbolicregression_jl_tpu/ops/pallas_eval.py:1014 "
                    "(_postfix_call via eval_loss_trees_pallas :1257)",
        "value": "symbolicregression_jl_tpu/ops/pallas_eval.py:1014 "
                 "(_postfix_call via eval_trees_pallas :1059)",
        "slots": "symbolicregression_jl_tpu/models/mutate_device.py:469 "
                 "(_const_fold_scan, a lax.scan, not a Pallas kernel)",
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
    headline = {"fused": T_CYCLE, "value": T_CYCLE, "slots": T_CYCLE,
                "loss_grad": T_OPT, "loss": T_OPT * LS_STEPS,
                "instr": T_CYCLE, "instr_packed": T_CYCLE}
    sources = dict.fromkeys(("fused", "value", "slots"), "postfix_eval")
    sources.update(loss_grad="postfix_grad", loss="postfix_grad",
                   instr="instr_eval", instr_packed="instr_eval")
    kernels = []
    for name in ("fused", "value", "slots", "loss_grad", "loss", "instr",
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
    for dt in ke.NARROW_STORAGE:
        sfx = ke.STORAGE[dt][1]
        precision = {torch.bfloat16: "bfloat16", torch.float16: "float16"}[dt]
        for name in ("value", "slots", "loss_grad", "loss", "instr",
                     "instr_packed"):
            h = storage_timing[(name + sfx, headline[name])]
            run = storage_runs[(precision, name if name.startswith("instr")
                                else "auto")]
            src = sources[name]
            kernels.append({
                "name": f"{src}{sfx}.{name}",
                "route": "cuda",
                "source": f"symbolicregression_jl_tpu_torch/csrc/{src}.cu",
                "build": f"-DSR_STORAGE={ke.STORAGE[dt][0]} ({precision})",
                "replaces": replaces[name] + (
                    ", compute_dtype=bfloat16 (:497-500, :578-582, :778-788)"
                    if dt == torch.bfloat16 else
                    ", at float16 (the jnp interpreter's rounding)"),
                "launches": run["storage"][name + sfx],
                "max_abs_err": store_err[name + sfx],
                "ms": h["ms"], "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                "library_ms": None,
                "float32_ms": h["f32_ms"],
                "nvcc_s": nvcc_s[src + sfx],
            })
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels, "card": card, "host": cpu,
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
                      "tiny_search": tiny}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
