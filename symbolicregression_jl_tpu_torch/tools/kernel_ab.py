"""A/B of the port's scoring and constant-optimisation kernels in two (or
more) versions of the package, on one card.

    python3 -m symbolicregression_jl_tpu_torch.tools.kernel_ab \\
        parent=<package root> current=. [--capture]

Each ``name=root`` is a directory that holds the package
``symbolicregression_jl_tpu_torch`` (for example an earlier commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists). Each root
builds its own kernels from its own sources (one process per root, all at
once), then each root is timed in a process of its own that imports that
root's package and drives its own wrappers (``prepare_launch`` /
``run_prepared`` of the scoring kernel, ``stage_launch`` of the
constant-optimisation kernels), so a change to a launcher's signature needs
no change here. The roots run in the order given, then in reverse (for two
roots: A B B A).

A timing process times each kernel alone (``device_ms``: the launches
queued behind a spin on the card, CUDA events around them) at the north
star's shapes (Feynman-I.6.2a, 2,048 rows): the value mode (B1) and the
fused L2 mode (B2) at 5,376 and 64,000 trees, the slot-values mode at 5,376
and 64,000 trees on one row (a root that still has it), the gradient
kernel (B3) at 26,880 instances
at max_len 24 and at max_len 128 (trees of 3-109 slots; ``null`` where the
root's wrapper refuses that max_len) and the loss-only kernel (B4) at
215,040 (26,880 trees x 8 candidates), and the instruction-program
kernels B5 / B6 at 5,376 and 64,000 trees; 50 launches each (20 for B4,
10 for B3 at max_len 128); the compact instantiation (these operators) and
the full one forced (``full:`` keys). Then the constant fold at 5,376 and
64,000 trees: the fold kernel alone (``fold@``, a root that has it,
``device_ms``) and the root's whole ``simplify_tree`` on the card, one
call captured as a CUDA graph and replayed (``simplify@``: the slot-values
launch and the PyTorch kernels around it in a root before the fold
kernel, the fold kernel's one launch after), 50 of each. Then the
wrappers, host prep included: ``eval_loss_trees`` at 5,376 and 64,000
trees, ``eval_slot_values`` at 5,376 and ``eval_trees_instr`` (both
programs) at 5,376 and 64,000. The outputs at 5,376 trees (value mode,
fused losses, slot values, ``simplify_tree``'s fields and ``changed``,
B5's and B6's values and poison flags), B3's losses, gradients and poison
flags at max_len 24 and B4's losses and poison flags are compared bit for
bit with the first root's, and B5's and B6's values with the root's own
value mode.

``--cycle`` adds, in each timing process, the main path's captured
cycle at the north star's widths: milliseconds per replayed cycle (two
runs of 50 replays, host clock) and device kernels per replay.
The trees of every timing are made with numpy
(``kernel_breakdown.fixed_length_trees``), the same in every root.

``--capture`` adds one batch from the main path's own search, the
children of the first cycle of iteration 2 of ``equation_search`` at 64
islands x 1000 (saved to ``build/kernel_ab/captured.pt`` and reused), timed
in the fused mode (``fused_l2@captured``). ``--hof`` adds, in each timing
process, the main path's search at the north star's widths for 1
iteration of 100 cycles (seed 0), timed (``hof_search_s``), and compares
its hall of fame (each member's complexity, loss bits and equation) with
the first root's. ``--main`` adds, in each timing process, chip_smoke
phase 5's search (the north star's widths, 2 iterations of 550 cycles,
seed 0, default constant optimisation): its seconds per iteration (host
clock at each ``on_iteration``, which reads the candidates' losses from
the card; the first iteration includes init and the capture) and of each
constant-optimisation pass (synchronized before and after).

The imports are absolute, so that this file, run by path in a root's
process, drives that root's package.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.models.trees import TreeBatch
from symbolicregression_jl_tpu_torch.ops import kernel_eval as ke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as kg
from symbolicregression_jl_tpu_torch.ops import kernel_instr as ki
from symbolicregression_jl_tpu_torch.ops.operators import make_operator_set
from symbolicregression_jl_tpu_torch.utils import rng as keyrng

OUT_DIR = ke.BUILD_DIR / "kernel_ab"
# the scoring kernel's fused mode (MODE_FUSED_L2 in the versions that fused
# L2 alone); timed here under L2, which every version computes
MODE_FUSED = getattr(ke, "MODE_FUSED", None) or ke.MODE_FUSED_L2
CAPTURED = OUT_DIR / "captured.pt"


def cuda_ms(fn, reps):
    """Milliseconds per call of fn over reps calls (CUDA events): the
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


def graph_ms(fn, reps):
    """Milliseconds per replay of a CUDA graph holding one call of fn
    (which must not read the card from the host): the device time of a
    call's kernels as the captured cycle runs them, without the host's
    launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up: plans and libraries, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


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


def synthetic_generator(seed: int, dev) -> torch.Generator:
    """A torch generator for synthetic kernel inputs (sizes, constant
    perturbations); the search itself draws from threefry keys."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def north_star_data(dev):
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(1.0, 3.0, 2048).astype(np.float32),
                     device=dev)[None]
    return X, torch.exp(-X[0] ** 2 / 2) / np.sqrt(2 * np.pi)


def mixed_trees(seed: int, T: int, lo: int, hi: int, ops, max_len: int,
                dev) -> TreeBatch:
    """T random programs of lo to hi - 1 slots, made with numpy
    (``kernel_breakdown.fixed_length_trees``), so every root gets the same
    trees whatever its random stream."""
    from symbolicregression_jl_tpu_torch.tools.kernel_breakdown import (
        fixed_length_trees,
    )

    g = np.random.default_rng(seed)
    sizes = g.integers(lo, hi, T)
    parts, where = [], []
    for n in np.unique(sizes):
        idx = np.nonzero(sizes == n)[0]
        parts.append(fixed_length_trees(g, len(idx), int(n), 1, ops, max_len,
                                        dev))
        where.append(idx)
    trees = TreeBatch(*(torch.cat(f) for f in zip(*parts)))
    return trees[torch.from_numpy(np.argsort(np.concatenate(where))).to(dev)]


def north_star_trees(ops, dev):
    trees = mixed_trees(1, 64000, 3, 21, ops, 24, dev)
    gen = synthetic_generator(1, dev)
    cv8 = trees[:26880].cval.repeat_interleave(8, 0) * (
        1 + 0.1 * torch.randn((26880 * 8, 24), generator=gen, device=dev))
    return trees, cv8


def long_trees(ops, dev):
    """26,880 trees of 3-109 slots at max_len 128 (a search at maxsize
    110 or more)."""
    return mixed_trees(4, 26880, 3, 110, ops, 128, dev)


def cycle_here(ncycles: int = 50) -> dict:
    """The main path's captured cycle at the north star's widths (64
    islands x 1000, 2,048 rows, maxsize 20): milliseconds per replayed
    cycle (host clock over ``ncycles`` replays after the capture, as
    chip_smoke phase 6 takes it) and device kernels per replay (20 replays
    profiled). A root older than the keyed random stream draws from a
    generator."""
    from torch.profiler import ProfilerActivity, profile

    from symbolicregression_jl_tpu_torch.models import cycle_graph as cg
    from symbolicregression_jl_tpu_torch.models import evolve
    from symbolicregression_jl_tpu_torch.models.dataset import (
        make_dataset, update_baseline_loss,
    )
    from symbolicregression_jl_tpu_torch.models.options import make_options

    dev = torch.device("cuda")
    X, y = north_star_data(dev)
    opts = make_options(binary_operators=["+", "-", "*", "/"],
                        unary_operators=["cos", "exp"], npopulations=64,
                        npop=1000, maxsize=20, verbosity=0)
    base = update_baseline_loss(make_dataset(X, y, device=dev),
                                opts).baseline_loss
    if hasattr(keyrng, "split"):
        st = evolve.init_island_state(keyrng.split(keyrng.key(2, dev), 64),
                                      opts, 1, X, y, None, base)
        head = ()
    else:
        gen = keyrng.make_generator(2, dev)
        st = evolve.init_island_state(gen, opts, 1, X, y, None, base, 64)
        head = (gen,)

    def run(n):
        torch.cuda.synchronize()
        t = time.time()
        cg.s_r_cycle_islands_graph(*head, st, opts.maxsize, X, y, None, base,
                                   opts, ncycles=n)
        torch.cuda.synchronize()
        return (time.time() - t) * 1e3 / n

    run(5)  # warm-up and capture
    ms = [run(ncycles), run(ncycles)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(20)
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"ms_per_cycle": ms, "kernels_per_cycle": n_kernels / 20}


class _Captured(Exception):
    pass


def capture_children(ops) -> TreeBatch:
    """The children scored by the first cycle of iteration 2 of the main
    path's search (64 islands x 1000, 2,048 rows, maxsize 20)."""
    if CAPTURED.exists():
        return TreeBatch(*torch.load(CAPTURED, map_location="cuda"))
    from symbolicregression_jl_tpu_torch import equation_search

    rng = np.random.default_rng(0)
    theta = rng.uniform(1.0, 3.0, 2048).astype(np.float32)
    y = (np.exp(-theta ** 2 / 2) / np.sqrt(2 * np.pi)).astype(np.float32)
    seen = {"iterations": 0, "batch": None}
    scoring = ke.eval_loss_trees
    # the eager cycle loop, whose every scoring call runs Python (a replay
    # of the captured cycle does not); it scores the same children
    import symbolicregression_jl_tpu_torch.api as api
    from symbolicregression_jl_tpu_torch.models.evolve import s_r_cycle_islands

    graph_cycles = api.s_r_cycle_islands_graph
    api.s_r_cycle_islands_graph = s_r_cycle_islands

    def spy(trees, X, y_, operators, *loss):
        if seen["iterations"] == 1 and trees.length.numel() == 64 * 84:
            seen["batch"] = ke._flatten(trees).map(torch.clone)
            raise _Captured
        return scoring(trees, X, y_, operators, *loss)

    ke.eval_loss_trees = spy
    try:
        equation_search(theta[None], y, binary_operators=["+", "-", "*", "/"],
                        unary_operators=["cos", "exp"], npopulations=64,
                        npop=1000, maxsize=20, loss="L2DistLoss",
                        niterations=2, ncycles_per_iteration=550, seed=0,
                        verbosity=0,
                        # (iteration, cands), or (output, iteration, cands)
                        # since the multi-output front door
                        on_iteration=lambda *a: seen.update(
                            iterations=a[-2] + 1))
    except _Captured:
        pass
    finally:
        ke.eval_loss_trees = scoring
        api.s_r_cycle_islands_graph = graph_cycles
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(tuple(seen["batch"]), CAPTURED)
    return seen["batch"]


# ---------------------------------------------------------------------------
# One root's process
# ---------------------------------------------------------------------------


def build_here() -> None:
    """Build this root's kernel libraries, one thread (nvcc) each, and
    print ptxas's register and spill lines."""
    mods = (ke, kg, ki)
    with ThreadPoolExecutor(len(mods)) as pool:
        for _ in pool.map(lambda m: m.build_library(force=True), mods):
            pass
    for m in mods:
        # a root older than the bfloat16 / float16 builds keeps BUILD_LOG
        log = (m.BUILD_LOGS[torch.float32] if hasattr(m, "BUILD_LOGS")
               else m.BUILD_LOG)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(m.__name__.rsplit(".", 1)[-1], line.strip())


def time_here(captured_path, bits_path) -> dict:
    """Every kernel and wrapper of this root's package, as the module
    docstring lists; the outputs the module docstring compares go to
    ``bits_path``."""
    dev = torch.device("cuda")
    ops = make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    X, y = north_star_data(dev)
    X1 = X[:, :1].contiguous()
    trees, cv8 = north_star_trees(ops, dev)
    cycle, opt = trees[64000 - 5376:], trees[:26880]
    long = long_trees(ops, dev)
    modes = [("value", ke.MODE_VALUE), ("fused_l2", MODE_FUSED)]
    slot_mode = getattr(ke, "MODE_SLOTS", None)  # before the fold kernel
    if slot_mode is not None:
        modes.append(("slots", slot_mode))
    shapes = [(f"{label}@{tb.length.shape[0]}", tb, mode)
              for label, mode in modes for tb in (cycle, trees)]
    if captured_path:
        captured = TreeBatch(*torch.load(captured_path, map_location="cuda"))
        shapes.append(("fused_l2@captured", captured, MODE_FUSED))
    uses_full = ke.uses_full_kernel
    row, outs = {}, {}
    try:
        for full in (False, True):
            ke.uses_full_kernel = lambda operators: full
            pre = "full:" if full else ""
            for label, tb, mode in shapes:
                p = ke.prepare_launch(
                    tb, X1 if mode == slot_mode else X,
                    y if mode == MODE_FUSED else None, ops, mode)
                row[pre + label] = device_ms(lambda: ke.run_prepared(p), 50)
                if (not full and label.endswith("@5376")
                        and mode != slot_mode):
                    outs[label] = p.out.nan_to_num().view(torch.int32).cpu()
                del p
            for name, packed in (("instr", False), ("instr_packed", True)):
                for tb in (cycle, trees):
                    T = tb.length.shape[0]
                    p = ki.prepare_launch(tb, X, ops, packed)
                    row[f"{pre}{name}@{T}"] = device_ms(
                        lambda: ki.run_prepared(p), 50)
                    if not full and T == 5376:
                        outs[name] = p.out.nan_to_num().view(torch.int32).cpu()
                        outs[name + "_bad"] = p.bad.cpu()
                    del p
            grad = kg.stage_launch(opt, X, y, None, ops, True, 1)
            row[f"{pre}loss_grad@26880"] = device_ms(lambda: grad(opt.cval), 50)
            try:
                grad_long = kg.stage_launch(long, X, y, None, ops, True, 1)
            except ValueError:  # a version that refuses max_len 128
                row[f"{pre}loss_grad@26880/L128"] = None
            else:
                row[f"{pre}loss_grad@26880/L128"] = device_ms(
                    lambda: grad_long(long.cval), 10)
                del grad_long
            loss = kg.stage_launch(opt, X, y, None, ops, False, 8)
            row[f"{pre}loss@215040"] = device_ms(lambda: loss(cv8), 20)
            if not full:
                lo, _, bad = loss(cv8)
                glo, gr, gbad = grad(opt.cval)
                torch.cuda.synchronize()
                torch.save({**outs,
                            "loss_bits": lo.view(torch.int32).cpu(),
                            "bad": bad.cpu(),
                            "grad_loss_bits": glo.view(torch.int32).cpu(),
                            "grad_bits": gr.view(torch.int32).cpu(),
                            "grad_bad": gbad.cpu()}, bits_path)
    finally:
        ke.uses_full_kernel = uses_full
    outs["slots@5376"] = ke.eval_slot_values(cycle, X1, ops)[0].nan_to_num(
        ).view(torch.int32).cpu()
    for tb in (cycle, trees):
        T = tb.length.shape[0]
        if hasattr(ke, "prepare_fold"):
            p = ke.prepare_fold(tb, ops)
            row[f"fold@{T}"] = device_ms(lambda: ke.run_fold(p), 50)
            del p
        else:
            row[f"fold@{T}"] = None
        row[f"simplify@{T}"] = graph_ms(lambda: tmut.simplify_tree(tb, ops),
                                        50)
        if T == 5376:
            folded, changed = tmut.simplify_tree(tb, ops)
            outs["simplify@5376"] = torch.cat(
                [f.reshape(T, -1).to(torch.float64).nan_to_num().view(
                    torch.int64) for f in folded]
                + [changed.reshape(T, 1).to(torch.int64)], 1).cpu()
    torch.save({**torch.load(bits_path), **{k: outs[k] for k in (
        "slots@5376", "simplify@5376")}}, bits_path)
    for T in (5376, 64000):
        tb = trees[64000 - T:]
        row[f"wrapper_fused_l2@{T}"] = cuda_ms(
            lambda: ke.eval_loss_trees(tb, X, y, ops), 20)
    row["wrapper_slots@5376"] = cuda_ms(
        lambda: ke.eval_slot_values(cycle, X1, ops), 20)
    for name, packed in (("instr", False), ("instr_packed", True)):
        for T in (5376, 64000):
            tb = trees[64000 - T:]
            row[f"wrapper_{name}@{T}"] = cuda_ms(
                lambda: ki.eval_trees_instr(tb, X, ops, packed), 20)
    return row


def hall_of_fame_here():
    """The main path's search at the north star's widths, 1 iteration of
    100 cycles at seed 0: its hall of fame as (complexity, loss bits,
    equation), and the search's seconds (host clock, init and capture
    included)."""
    from symbolicregression_jl_tpu_torch import equation_search

    X, y = north_star_data(torch.device("cuda"))
    torch.cuda.synchronize()
    t = time.time()
    res = equation_search(X.cpu().numpy(), y.cpu().numpy(), niterations=1,
                          ncycles_per_iteration=100, seed=0,
                          binary_operators=["+", "-", "*", "/"],
                          unary_operators=["cos", "exp"], npopulations=64,
                          npop=1000, maxsize=20, verbosity=0)
    torch.cuda.synchronize()
    return ([(c.complexity, float(c.loss).hex(), c.equation)
             for c in res.frontier()], time.time() - t)


def main_path_here(niterations: int = 2, ncycles: int = 550) -> dict:
    """chip_smoke phase 5's search: seconds (host clock) and best loss of
    each iteration, and the seconds of each iteration's constant-
    optimisation pass (host clock, synchronized before and after)."""
    from symbolicregression_jl_tpu_torch import api, equation_search

    X, y = north_star_data(torch.device("cuda"))
    X_np, y_np = X.cpu().numpy(), y.cpu().numpy()
    torch.cuda.synchronize()
    t = [time.time()]
    per_iter, best, opt_s = [], [], []
    untimed = api.optimize_islands_constants

    def on_iteration(j, it, cands):
        best.append(min(c.loss for c in cands))
        per_iter.append(time.time() - t[0])
        t[0] = time.time()

    def timed(*a, **k):
        torch.cuda.synchronize()
        t_o = time.time()
        out = untimed(*a, **k)
        torch.cuda.synchronize()
        opt_s.append(time.time() - t_o)
        return out

    api.optimize_islands_constants = timed
    try:
        equation_search(X_np, y_np, niterations=niterations,
                        ncycles_per_iteration=ncycles, seed=0,
                        on_iteration=on_iteration,
                        binary_operators=["+", "-", "*", "/"],
                        unary_operators=["cos", "exp"], npopulations=64,
                        npop=1000, maxsize=20, loss="L2DistLoss", verbosity=0)
    finally:
        api.optimize_islands_constants = untimed
    return {"s_per_iteration": per_iter, "best_loss": best,
            "optimisation_pass_s": opt_s}


def worker(argv) -> int:
    """``--worker root build`` or ``--worker root time bits [captured]
    [--hof] [--cycle] [--main]``: check that the package imported is the
    root's, then do the one job."""
    hof, cycle, main_path = ("--hof" in argv, "--cycle" in argv,
                             "--main" in argv)
    argv = [a for a in argv if a not in ("--hof", "--cycle", "--main")]
    root, job = pathlib.Path(argv[0]).resolve(), argv[1]
    if root not in pathlib.Path(ke.__file__).resolve().parents:
        raise RuntimeError(f"imported {ke.__file__}, not the package of {root}")
    if job == "build":
        build_here()
        return 0
    row = time_here(argv[3] if len(argv) > 3 else None, argv[2])
    if hof:
        row["hof"], row["hof_search_s"] = hall_of_fame_here()
    if cycle:
        row["cycle"] = cycle_here()
    if main_path:
        row["main_path"] = main_path_here()
    print(json.dumps(row))
    return 0


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


def run_in(root: pathlib.Path, *args) -> str:
    """This file, by path, in a process whose package is ``root``'s."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, __file__, "--worker", str(root),
                           *args], cwd=root, env=env, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {' '.join(args)} failed\n{proc.stdout}"
                           f"\n{proc.stderr}")
    return proc.stdout


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available")
        return 2
    capture = "--capture" in argv
    hof = ["--hof"] if "--hof" in argv else []
    cycle = ["--cycle"] if "--cycle" in argv else []
    main_path = ["--main"] if "--main" in argv else []
    roots = {n: pathlib.Path(r).resolve() for n, r in
             (a.split("=", 1) for a in argv if not a.startswith("--"))}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    captured = []
    if capture:
        capture_children(make_operator_set(["+", "-", "*", "/"], ["cos", "exp"]))
        captured = [str(CAPTURED)]
    with ThreadPoolExecutor(len(roots)) as pool:
        logs = dict(zip(roots, pool.map(lambda r: run_in(r, "build"),
                                        roots.values())))
    for name, log in logs.items():
        for line in log.splitlines():
            print(name, line)
    rows, bits = [], {}
    for name in list(roots) + list(reversed(roots)):
        path = OUT_DIR / f"bits_{name}.pt"
        row = {"tree": name, **json.loads(run_in(
            roots[name], "time", str(path), *captured, *hof,
            *cycle, *main_path).splitlines()[-1])}
        bits.setdefault(name, torch.load(path))
        print(json.dumps(row), flush=True)
        rows.append(row)
    ref = bits[next(iter(roots))]
    checks = {}
    outputs = ("value@5376", "fused_l2@5376", "slots@5376", "simplify@5376",
               "instr", "instr_bad", "instr_packed", "instr_packed_bad")
    for name, b in bits.items():
        if not torch.equal(b["value@5376"], ref["value@5376"]):
            raise AssertionError(f"{name}: value mode differs from the first root")
        checks[name] = dict(
            {f"{k}_differ": int((b[k] != ref[k]).sum()) for k in outputs},
            instr_vs_value_differ=int((b["instr"] != b["value@5376"]).sum()),
            instr_packed_vs_value_differ=int(
                (b["instr_packed"] != b["value@5376"]).sum()),
            loss_bits_differ=int((b["loss_bits"] != ref["loss_bits"]).sum()),
            poison_differs=int((b["bad"] != ref["bad"]).sum()),
            b3_loss_bits_differ=int(
                (b["grad_loss_bits"] != ref["grad_loss_bits"]).sum()),
            b3_grad_bits_differ=int((b["grad_bits"] != ref["grad_bits"]).sum()),
            b3_poison_differs=int((b["grad_bad"] != ref["grad_bad"]).sum()))
        print(f"{name}: outputs against the first root {checks[name]}",
              flush=True)
    if hof:
        first = rows[0]["hof"]
        for row in rows:
            checks[row["tree"]]["hof_equal"] = row["hof"] == first
        if not all(row["hof"] == first for row in rows):
            raise AssertionError("the halls of fame differ between the roots")
        print(f"halls of fame: bit-equal in every run ({len(first)} members)",
              flush=True)
    record = {"card": card, "rows": rows, "loss_bits": checks}
    if capture:
        lengths = capture_children(None).length.float()
        record["captured"] = {"trees": int(lengths.numel()),
                              "mean_length": float(lengths.mean()),
                              "max_length": int(lengths.max())}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
