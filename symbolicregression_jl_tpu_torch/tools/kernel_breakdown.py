"""Where the scoring, constant-optimisation and instruction-program kernels
spend their time, on one card.

    python3 -m symbolicregression_jl_tpu_torch.tools.kernel_breakdown \\
        [--out chiprun_out/breakdown] [--skip-cycle]

Three readings that stand in for a profiler of the kernels:

1. the SASS of ``build/libpostfix_eval.so``, ``build/libpostfix_grad.so``
   and ``build/libinstr_eval.so`` (``cuobjdump -sass``), written to
   ``<out>/sass_<library>.txt``, with each kernel's instruction count
   printed;
2. B2 (the fused L2 scoring mode) at 5,376 trees, B3 (the gradient
   kernel) at 26,880 instances, B4 (the loss-only kernel) at 26,880
   trees x 8 candidates and B5 / B6 (the instruction-program kernels) at
   5,376 trees, each on batches whose trees all have one length (3, 7,
   11, 15, 19 and 23 slots), x 2,048 rows, with CUDA events; a
   least-squares line ms = fixed + per_slot * length separates the cost of
   a slot step from the cost that does not grow with it (for B5 / B6 also
   against the batch's mean number of instructions, ``per_step``);
3. host synchronisations per evolution cycle at the north star's widths
   (64 islands x 1000): the profiler's CUDA runtime events of 10 cycles
   (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
   ``cudaEventSynchronize``, ``cudaMemcpy*``), each with the PyTorch
   operator that issued it.

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from ..models.trees import BIN, CONST, UNA, VAR, TreeBatch
from ..ops import kernel_eval as ke
from ..ops import kernel_grad as kg
from ..ops import kernel_instr as ki
from ..ops.operators import OperatorSet, make_operator_set
from .kernel_ab import device_ms

ROWS = 2048
LENGTHS = (3, 7, 11, 15, 19, 23)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def fixed_length_trees(rng: np.random.Generator, T: int, n: int, nfeat: int,
                       operators: OperatorSet, max_len: int,
                       device) -> TreeBatch:
    """T random valid postfix programs of exactly ``n`` slots: each slot
    draws leaf / unary / binary among the kinds that still let the program
    end with one stack entry (leaves are CONST ~ N(0, 1) or VAR, half
    each). An even ``n`` needs a unary operator."""
    if n % 2 == 0 and operators.n_unary == 0:
        raise ValueError("an even length needs a unary operator")
    kind = np.zeros((T, max_len), np.int64)
    op = np.zeros((T, max_len), np.int64)
    feat = np.zeros((T, max_len), np.int64)
    cval = np.zeros((T, max_len), np.float32)
    depth = np.zeros(T, np.int64)
    weights = np.array([0.45, 0.15 if operators.n_unary else 0.0,
                        0.4 if operators.n_binary else 0.0])
    for i in range(n):
        left = n - i  # slots left, this one included
        # a leaf leaves depth + 1 to reduce to 1 in left - 1 slots
        allowed = np.stack([depth <= left - 1, (depth >= 1) & (depth <= left),
                            depth >= 2], -1)
        p = allowed * weights
        p /= p.sum(-1, keepdims=True)
        choice = (rng.random(T)[:, None] > np.cumsum(p, -1)).sum(-1)
        is_leaf, is_una, is_bin = choice == 0, choice == 1, choice == 2
        const = is_leaf & (rng.random(T) < 0.5)
        kind[:, i] = np.where(is_una, UNA, np.where(is_bin, BIN,
                                                    np.where(const, CONST, VAR)))
        op[:, i] = np.where(is_una, rng.integers(0, max(operators.n_unary, 1), T),
                            np.where(is_bin, rng.integers(0, max(operators.n_binary, 1), T), 0))
        feat[:, i] = np.where(is_leaf & ~const, rng.integers(0, nfeat, T), 0)
        cval[:, i] = np.where(const, rng.standard_normal(T), 0.0)
        depth += is_leaf.astype(np.int64) - is_bin.astype(np.int64)
    assert (depth == 1).all()
    as_t = lambda a: torch.tensor(a, device=device)
    return TreeBatch(as_t(kind), as_t(op), as_t(feat), as_t(cval),
                     torch.full((T,), n, dtype=torch.int64, device=device))


def fit_line(xs, ys):
    """(intercept, slope) of the least-squares line."""
    slope, intercept = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return float(intercept), float(slope)


def sass(out_dir: pathlib.Path) -> dict:
    """Dump each library's SASS; instruction count per kernel function."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    counts = {}
    for lib in (ke.LIBRARY, kg.LIBRARY, ki.LIBRARY):
        text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        (out_dir / f"sass_{lib.stem}.txt").write_text(text)
        fn = None
        for line in text.splitlines():
            s = line.strip()
            if s.startswith("Function :"):
                fn = s.split(":", 1)[1].strip()
                counts[fn] = 0
            elif fn and s.startswith("/*") and "*/" in s and s[2:6].strip("0123456789abcdef") == "":
                counts[fn] += 1
    return counts


def sync_counts(prof) -> tuple:
    """(by name, by name and issuing operator) of the CUDA runtime calls in
    a profile that wait for the device or copy (``cudaMemcpyAsync`` also
    copies on the device), with the copies the device ran by direction
    (``Memcpy HtoD`` / ``DtoH`` / ``DtoD``, by name only)."""
    by_call = collections.Counter()
    by_op = collections.Counter()
    for e in prof.events():
        if e.name.startswith("Memcpy"):
            by_call[e.name] += 1
        if not e.name.startswith(SYNC_CALLS):
            continue
        by_call[e.name] += 1
        parent, chain = e.cpu_parent, []
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        top = next((c for c in reversed(chain) if c.startswith("aten::")), None)
        near = chain[0] if chain else None
        by_op[f"{e.name} <- {near} (top {top})"] += 1
    return by_call, by_op


def host_syncs(cycles: int = 10) -> dict:
    """CUDA runtime calls that wait for the device, per evolution cycle at
    64 islands x 1000, by the PyTorch operator that issued them."""
    from torch.profiler import ProfilerActivity, profile

    from ..models.dataset import make_dataset, update_baseline_loss
    from ..models.evolve import init_island_state, s_r_cycle_islands
    from ..models.options import make_options
    from ..utils import rng as keyrng

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    theta = rng.uniform(1.0, 3.0, ROWS).astype(np.float32)
    X = torch.tensor(theta[None], device=dev)
    y = torch.exp(-X[0] ** 2 / 2) / np.sqrt(2 * np.pi)
    opts = make_options(binary_operators=["+", "-", "*", "/"],
                        unary_operators=["cos", "exp"], npopulations=64,
                        npop=1000, maxsize=20, loss="L2DistLoss", verbosity=0)
    base = update_baseline_loss(make_dataset(X, y, device=dev),
                                opts).baseline_loss
    st = init_island_state(keyrng.split(keyrng.key(2, dev), 64), opts, 1, X,
                           y, None, base)
    st = s_r_cycle_islands(st, opts.maxsize, X, y, None, base, opts, ncycles=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st = s_r_cycle_islands(st, opts.maxsize, X, y, None, base, opts,
                               ncycles=cycles)
    by_call, by_op = sync_counts(prof)
    runtime = sum(n for c, n in by_call.items() if c.startswith(SYNC_CALLS))
    return dict(cycles=cycles, total=runtime, per_cycle=runtime / cycles,
                by_call=dict(by_call), by_operator=dict(by_op.most_common(30)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/breakdown")
    ap.add_argument("--skip-cycle", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device is available")
        return 2
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for m in (ke, kg, ki):
        m.build_library(force=True)
    for log in (m.BUILD_LOGS[torch.float32] for m in (ke, kg, ki)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("ptxas", line.strip())
    record = {"card": card, "sass_instructions": sass(out_dir)}
    print("sass instructions per kernel:", record["sass_instructions"], flush=True)

    dev = torch.device("cuda")
    ops = make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    rng = np.random.default_rng(0)
    theta = rng.uniform(1.0, 3.0, ROWS).astype(np.float32)
    X = torch.tensor(theta[None], device=dev)
    y = torch.exp(-X[0] ** 2 / 2) / np.sqrt(2 * np.pi)
    b2, b3, b4, b5, b6, steps = {}, {}, {}, {}, {}, {}
    for n in LENGTHS:
        tb = fixed_length_trees(rng, 5376, n, 1, ops, 24, dev)
        prep = ke.prepare_launch(tb, X, y, ops, ke.MODE_FUSED)
        b2[n] = device_ms(lambda: ke.run_prepared(prep), 50)
        steps[n] = float((tb.kind >= UNA).sum(-1).clamp_min(1).float().mean())
        for b, packed in ((b5, False), (b6, True)):
            ip = ki.prepare_launch(tb, X, ops, packed)
            b[n] = device_ms(lambda: ki.run_prepared(ip), 50)
        opt = fixed_length_trees(rng, 26880, n, 1, ops, 24, dev)
        cv = opt.cval.repeat_interleave(8, 0) * (
            1 + 0.1 * torch.randn((26880 * 8, 24), device=dev))
        raw = kg.stage_launch(opt, X, y, None, ops, False, 8)
        b4[n] = device_ms(lambda: raw(cv), 10)
        grad = kg.stage_launch(opt, X, y, None, ops, True, 1)
        b3[n] = device_ms(lambda: grad(opt.cval), 20)
        print(f"length {n}: B2 (5,376 trees) {b2[n]:.4f} ms, B3 (26,880 "
              f"instances) {b3[n]:.4f} ms, B4 (215,040 instances) "
              f"{b4[n]:.4f} ms, B5 / B6 (5,376 trees, {steps[n]:.2f} "
              f"instructions per tree) {b5[n]:.4f} / {b6[n]:.4f} ms",
              flush=True)
    for name, ms, work in (("B2", b2, 5376 * ROWS), ("B3", b3, 26880 * ROWS),
                           ("B4", b4, 26880 * 8 * ROWS),
                           ("B5", b5, 5376 * ROWS), ("B6", b6, 5376 * ROWS)):
        fixed, per = fit_line(list(ms), list(ms.values()))
        record[name] = dict(ms_by_length=ms, fixed_ms=fixed, ms_per_slot=per,
                            ns_per_step_per_1k_rows=per * 1e6 / (work / 1e3))
        if name in ("B5", "B6"):
            fixed_s, per_s = fit_line([steps[n] for n in ms], list(ms.values()))
            record[name].update(instructions_by_length=steps,
                                fixed_ms_by_step=fixed_s, ms_per_step=per_s)
        print(f"{name}: fixed {fixed:.4f} ms + {per:.5f} ms per slot "
              f"({work * 1e-3 / per:.4g} steps*rows/s per slot step)", flush=True)
    if not args.skip_cycle:
        t = time.time()
        record["host_syncs"] = host_syncs()
        print(f"host syncs: {record['host_syncs']} ({time.time() - t:.1f} s)",
              flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
