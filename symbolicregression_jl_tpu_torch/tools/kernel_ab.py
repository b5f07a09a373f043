"""A/B of the port's CUDA kernels built from two (or more) source trees, in
one process on one card.

    python3 -m symbolicregression_jl_tpu_torch.tools.kernel_ab \\
        parent=<dir> current=symbolicregression_jl_tpu_torch/csrc

Each ``name=dir`` holds ``postfix_eval.cu`` and ``postfix_grad.cu`` (and,
where it has them, ``instr_eval.cu``), for example an earlier commit's
``csrc/`` unpacked with ``git archive`` into a directory that ``.gitignore``
lists. Every tree is built with the flags the package uses, one nvcc
process each, into ``build/kernel_ab/``; then each kernel is timed at the
north star's shapes (Feynman-I.6.2a, 2,048 rows; scoring at 5,376 and
64,000 trees, the gradient variant at 26,880 instances, the loss-only
variant at 215,040) with CUDA events over 50 launches (20 for the
loss-only variant), the trees in the order given, then the reverse (for
two trees: A B B A). A tree whose launchers take the full-instantiation
flag is timed twice, as the wrappers launch it (the compact instantiation,
for these operators) and with the full one forced (keys ``full:...``). A
tree's opcodes are read from its source (the first binary id, ``OP_ADD``),
so trees that number the operators differently time the same programs.
The value mode's output is checked bit-equal across trees first.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models.mutate_device import gen_random_tree_fixed_size
from ..ops import kernel_eval as ke
from ..ops import kernel_grad as kg
from ..ops import kernel_instr as ki
from ..ops.operators import KERNEL_BINARY_IDS, make_operator_set
from ..utils.rng import make_generator

SOURCES = ("postfix_eval", "postfix_grad", "instr_eval")


def takes_full_flag(src_dir: pathlib.Path) -> bool:
    """The tree's launchers take the full-instantiation flag (all_ops)."""
    return "all_ops" in (src_dir / "postfix_eval.cu").read_text()


class _WithoutFullFlag:
    """A tree's postfix_grad library whose launcher has no all_ops
    argument, behind the current interface."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def postfix_grad_launch(self, *args):
        return self._lib.postfix_grad_launch(*args[:-2], args[-1])


def first_binary_id(src_dir: pathlib.Path) -> int:
    """OP_ADD as the tree's sources define it."""
    for path in sorted(src_dir.glob("*.cu*")):
        m = re.search(r"OP_ADD\s*=\s*(\d+)", path.read_text())
        if m:
            return int(m.group(1))
    raise ValueError(f"no OP_ADD in {src_dir}")


def build(trees: dict) -> dict:
    """{(tree, source): library} for every source each tree has."""
    out_dir = ke.BUILD_DIR / "kernel_ab"
    jobs = {}
    with ThreadPoolExecutor(len(trees) * len(SOURCES)) as pool:
        for name, src_dir in trees.items():
            for src in SOURCES:
                if (src_dir / f"{src}.cu").exists():
                    extra = kg.NVCC_EXTRA_FLAGS if src == "postfix_grad" else ()
                    lib = out_dir / f"lib{src}_{name}.so"
                    jobs[name, src] = (lib, pool.submit(
                        ke.compile_library, src_dir / f"{src}.cu", lib, extra))
        libs = {}
        for key, (lib, fut) in jobs.items():
            for line in fut.result().splitlines():
                if "registers" in line or "spill" in line:
                    print(*key, line.strip())
            libs[key] = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    for (name, src), lib in libs.items():
        flag = int(takes_full_flag(trees[name]))
        if src == "postfix_eval":
            lib.postfix_eval_launch.argtypes = [p] * 11 + [i] * (4 + flag) + [p]
            lib.postfix_eval_launch.restype = i
        elif src == "postfix_grad":
            lib.postfix_grad_launch.argtypes = [p] * 13 + [i] * (5 + flag) + [p]
            lib.postfix_grad_launch.restype = i
            lib.postfix_grad_smem_bytes.argtypes = [i, i]
            lib.postfix_grad_smem_bytes.restype = i
            lib.postfix_grad_max_smem_bytes.restype = i
            lib.postfix_grad_error_string.argtypes = [i]
            lib.postfix_grad_error_string.restype = ctypes.c_char_p
        else:
            lib.instr_eval_launch.argtypes = [p] * 12 + [i] * 6 + [p]
            lib.instr_eval_launch.restype = i
            lib.instr_eval_warps_per_block.argtypes = [i, i, i]
            lib.instr_eval_warps_per_block.restype = i
            lib.instr_eval_error_string.argtypes = [i]
            lib.instr_eval_error_string.restype = ctypes.c_char_p
    return libs


def cuda_ms(fn, reps):
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available")
        return 2
    trees_dirs = dict(a.split("=", 1) for a in argv)
    trees_dirs = {k: pathlib.Path(v) for k, v in trees_dirs.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    libs = build(trees_dirs)
    shift = {k: first_binary_id(d) - min(KERNEL_BINARY_IDS.values())
             for k, d in trees_dirs.items()}
    dev = torch.device("cuda")
    ops = make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(1.0, 3.0, 2048).astype(np.float32),
                     device=dev)[None]
    y = torch.exp(-X[0] ** 2 / 2) / np.sqrt(2 * np.pi)
    gen = make_generator(1, dev)
    trees = gen_random_tree_fixed_size(
        gen, torch.randint(3, 21, (64000,), generator=gen, device=dev), 1, ops,
        24, dev)
    cycle, opt = trees[64000 - 5376:], trees[:26880]
    cv8 = opt.cval.repeat_interleave(8, 0) * (
        1 + 0.1 * torch.randn((26880 * 8, 24), generator=gen, device=dev))
    stream = torch.cuda.current_stream().cuda_stream
    binary_base = min(KERNEL_BINARY_IDS.values())

    def eval_launch(name, tb, mode, force_full=False):
        prep = ke.prepare_launch(tb, X, y if mode == ke.MODE_FUSED_L2 else None,
                                 ops, mode)
        *tensors, T, L, nrows, m, full = prep.args
        code = tensors[0]
        tensors[0] = torch.where(code >= binary_base, code + shift[name],
                                 code).contiguous()
        ptrs = [None if t is None else t.data_ptr() for t in tensors]
        ints = (T, L, nrows, m, int(full or force_full))[
            :4 + takes_full_flag(trees_dirs[name])]
        lib = libs[name, "postfix_eval"]

        def run():
            if lib.postfix_eval_launch(*ptrs, *ints, stream):
                raise RuntimeError(f"{name}: postfix_eval launch failed")

        return run, prep.out, tensors

    def grad_launch(name, with_grad, force_full=False):
        lib = libs[name, "postfix_grad"]
        kg._lib = (lib if takes_full_flag(trees_dirs[name])
                   else _WithoutFullFlag(lib))
        saved = dict(KERNEL_BINARY_IDS), ke.uses_full_kernel
        KERNEL_BINARY_IDS.update({k: v + shift[name] for k, v in saved[0].items()})
        if force_full:
            ke.uses_full_kernel = lambda operators: True
        try:
            raw = kg.stage_launch(opt, X, y, None, ops, with_grad,
                                  1 if with_grad else 8)
        finally:
            KERNEL_BINARY_IDS.update(saved[0])
            ke.uses_full_kernel = saved[1]
        cv = opt.cval if with_grad else cv8
        return lambda: raw(cv)

    def instr_launch(name, tb, packed, force_full=False):
        ki._lib = libs[name, "instr_eval"]
        prep = ki.prepare_launch(tb, X, ops, packed)
        if force_full:
            prep = prep._replace(args=prep.args[:-1] + (1,))
        return lambda: ki.run_prepared(prep)

    ref = None
    for name in trees_dirs:
        run, out, _ = eval_launch(name, cycle, ke.MODE_VALUE)
        run()
        torch.cuda.synchronize()
        out = out.nan_to_num()
        if ref is not None and not torch.equal(out, ref):
            raise AssertionError(f"{name}: value mode differs from the first tree")
        ref = out
    order = list(trees_dirs) + list(reversed(trees_dirs))
    rows = []
    for name in order:
        row = {"tree": name}
        for full in (False, True)[:1 + takes_full_flag(trees_dirs[name])]:
            pre = "full:" if full else ""
            for label, tb, mode in (("value", cycle, ke.MODE_VALUE),
                                    ("value", trees, ke.MODE_VALUE),
                                    ("fused_l2", cycle, ke.MODE_FUSED_L2),
                                    ("fused_l2", trees, ke.MODE_FUSED_L2)):
                run, _, keep = eval_launch(name, tb, mode, full)
                row[f"{pre}{label}@{tb.length.shape[0]}"] = cuda_ms(run, 50)
                del keep
            row[f"{pre}loss_grad@26880"] = cuda_ms(grad_launch(name, True, full), 50)
            row[f"{pre}loss@215040"] = cuda_ms(grad_launch(name, False, full), 20)
            if (name, "instr_eval") in libs:
                for packed in (False, True):
                    for tb in (cycle, trees):
                        key = (f"{pre}{'instr_packed' if packed else 'instr'}"
                               f"@{tb.length.shape[0]}")
                        row[key] = cuda_ms(instr_launch(name, tb, packed, full),
                                           50)
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
