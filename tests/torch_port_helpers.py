"""Shared fixtures for the PyTorch-port parity tests: the same numpy inputs,
made from a seed, go to the JAX package and to the port. The JAX package
is imported only by the functions that build or read its trees, so the
card-only tests, on a machine without JAX, can use the rest."""

import math

import numpy as np
import torch

from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models.trees import (
    BIN, CONST, PAD, UNA, VAR, TreeBatch,
)
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke

# one thread per test process: the suite runs several worker processes side by side
torch.set_num_threads(1)

L = 24


def jax_trees(rng, ops, n, nfeat, max_size=22, min_size=1, exprs=()):
    """A JAX TreeBatch of n random trees (plus any extra Exprs)."""
    import symbolicregression_jl_tpu.models.trees as jtrees
    from symbolicregression_jl_tpu.utils.random_exprs import (
        random_expr_fixed_size,
    )

    es = [random_expr_fixed_size(rng, ops, nfeat,
                                 int(rng.integers(min_size, max_size + 1)))
          for _ in range(n)]
    return jtrees.stack_trees([jtrees.encode_tree(e, L) for e in [*es, *exprs]])


def to_numpy(trees):
    return {f: np.asarray(getattr(trees, f)) for f in trees._fields}


def port_trees(jt, device="cpu"):
    """The same trees as the port's TreeBatch."""
    return convert.trees_from_numpy(to_numpy(jt), device)


def assert_trees_equal(jt, tt):
    for f in jt._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      getattr(tt, f).cpu().numpy(), err_msg=f)


def deep_trees(max_len, nfeat, binary_ops=(0, 1), unary_op=0, device="cpu"):
    """Port trees at ``max_len`` whose stacks run deep: x0 c x1 c ... (k
    leaves, k = (max_len + 1) // 2 - 1 or 300, whichever is less) then k - 1
    binary slots cycling through ``binary_ops`` (a stack of k entries);
    the same sum cut to stack 260 with a unary slot after every binary
    one; and a chain of max_len - 1 unary slots on x0 (one instruction per
    slot)."""
    L = max_len

    def tree(kinds):
        kind = np.zeros(L, np.int64)
        op = np.zeros(L, np.int64)
        feat = np.zeros(L, np.int64)
        cval = np.zeros(L, np.float32)
        leaves = 0
        for i, (k, o) in enumerate(kinds):
            kind[i], op[i] = k, o
            if k in (VAR, CONST):
                feat[i] = leaves % nfeat if k == VAR else 0
                cval[i] = 0.25 + 0.001 * leaves if k == CONST else 0.0
                leaves += 1
        return kind, op, feat, cval, len(kinds)

    def leaves(k):
        return [(VAR if i % 2 == 0 else CONST, 0) for i in range(k)]

    k = min(300, (L + 1) // 2 - 1)
    k2 = min(260, (L + 2) // 3)
    rows = [
        tree(leaves(k) + [(BIN, binary_ops[j % len(binary_ops)])
                          for j in range(k - 1)]),
        tree(leaves(k2) + [s for j in range(k2 - 1)
                           for s in ((BIN, binary_ops[j % len(binary_ops)]),
                                     (UNA, unary_op))]),
        tree([(VAR, 0)] + [(UNA, unary_op)] * (L - 1)),
    ]
    as_t = lambda i, dt: torch.tensor(np.stack([r[i] for r in rows]), dtype=dt,
                                      device=device)
    return TreeBatch(as_t(0, torch.int64), as_t(1, torch.int64),
                     as_t(2, torch.int64), as_t(3, torch.float32),
                     torch.tensor([r[4] for r in rows], dtype=torch.int64,
                                  device=device))


def jax_batch(tt):
    """The port's TreeBatch as the JAX package's."""
    import jax.numpy as jnp
    import symbolicregression_jl_tpu.models.trees as jtrees

    return jtrees.TreeBatch(**{f: jnp.asarray(getattr(tt, f).numpy())
                               for f in tt._fields})


# every name of the loss registry, then each parameterised factory at a
# parameter other than its default: the labels of the loss tests
LOSS_FACTORIES = (("lp_dist_loss", 3.0), ("huber_loss", 2.0),
                  ("l1_epsilon_ins_loss", 0.3), ("l2_epsilon_ins_loss", 0.3),
                  ("periodic_loss", 3.0), ("quantile_loss", 0.3),
                  ("smoothed_l1_hinge_loss", 0.5), ("dwd_margin_loss", 2.0))


def loss_labels():
    from symbolicregression_jl_tpu_torch.ops.losses import LOSS_REGISTRY

    return sorted(LOSS_REGISTRY) + [f"{f}({p})" for f, p in LOSS_FACTORIES]


def loss_pair(label):
    """(the JAX package's loss, the port's ``ElementwiseLoss``) of a label
    of ``loss_labels``."""
    from symbolicregression_jl_tpu.ops import losses as jlosses
    from symbolicregression_jl_tpu_torch.ops import losses as tlosses

    if label in tlosses.LOSS_REGISTRY:
        return jlosses.LOSS_REGISTRY[label], tlosses.LOSS_REGISTRY[label]
    name, p = label[:-1].split("(")
    return getattr(jlosses, name)(float(p)), getattr(tlosses, name)(float(p))


def make_generator(seed: int, device) -> torch.Generator:
    """A torch generator for a test's synthetic inputs (tree sizes, data,
    constants); the search itself draws from threefry keys."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def island_keys(seed: int, n: int, device="cpu") -> torch.Tensor:
    """n threefry keys split from ``PRNGKey(seed)``: (n, 2)."""
    from symbolicregression_jl_tpu_torch.utils import rng
    return rng.split(rng.key(seed, device), n)


def random_trees(gen: torch.Generator, sizes, nfeatures, operators, max_len,
                 device, dtype=torch.float32):
    """Random trees grown by the port's ``gen_random_tree_fixed_size`` to
    ``sizes``, one threefry key per tree drawn from ``gen``."""
    from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
    keys = torch.randint(0, 2 ** 32, (sizes.shape[0], 2), generator=gen,
                         device=device)
    return tmut.gen_random_tree_fixed_size(keys, sizes, nfeatures, operators,
                                           max_len, dtype)


def fold_trees_mirror(trees, operators):
    """The fold kernel's algorithm in Python, one tree at a time in the
    kernel's order (the mirror its CPU tests hold against
    ``simplify_tree_plain``, the plain version the card holds the kernel
    against): the kernel's validity rules per slot, then one walk whose
    output map doubles as the value stack (a constant child is one output
    slot; a parent whose children are all constant and whose value is
    finite replaces them, so a child is a fold root exactly when its
    parent does not take it in), then the write-back, an unchanged tree as
    it was. Each operator's value is its slot's value on a zero row
    (``eval_slot_values_plain``): a folded subtree holds no variable, and
    the kernel computes that value from the same children."""
    T, L = trees.kind.shape
    cap = (L + 1) // 2
    zero = torch.zeros((1, 1), dtype=trees.cval.dtype)
    vals = tke.eval_slot_values_plain(
        trees._replace(feat=torch.zeros_like(trees.feat)), zero,
        operators)[0].tolist()
    kind, op, feat, cval, length = (f.tolist() for f in trees)
    U, B = operators.n_unary, operators.n_binary
    fold = -1  # the output map's mark of a folded constant
    changed = [False] * T
    for t in range(T):
        n = length[t]
        invalid = n < 0 or n > L
        n = 0 if invalid else n
        depth = out = 0
        A, V = [0] * L, [0.0] * L
        for s in range(n):
            k, o = kind[t][s], op[t][s]
            if k in (PAD, CONST, VAR):
                if depth >= cap:
                    invalid = True
                    break
                depth += 1
                x = cval[t][s] if k == CONST else 0.0
                A[out] = fold if k != VAR and math.isfinite(x) else s
                V[out] = x
                out += 1
            elif (k == UNA and 0 <= o < U) or (k == BIN and 0 <= o < B):
                binary = k == BIN
                if depth < (2 if binary else 1):
                    invalid = True
                    break
                depth -= binary
                top = out - 1
                x = vals[t][s]
                if (A[top] == fold and (not binary or A[top - 1] == fold)
                        and math.isfinite(x)):
                    out -= binary
                    A[out - 1], V[out - 1] = fold, x
                else:
                    A[out] = s
                    out += 1
            else:
                invalid = True
                break
        invalid |= n > 0 and depth != 1
        if invalid or out >= n:
            continue
        changed[t] = True
        rows = [[PAD, 0, 0, 0.0] for _ in range(L)]
        for j in range(out):
            rows[j] = ([CONST, 0, 0, V[j]] if A[j] == fold else
                       [kind[t][A[j]], op[t][A[j]], feat[t][A[j]],
                        cval[t][A[j]]])
        kind[t], op[t], feat[t], cval[t] = (list(c) for c in zip(*rows))
        length[t] = out
    as_t = lambda x, f: torch.tensor(x, dtype=f.dtype)  # noqa: E731
    return (TreeBatch(*(as_t(x, f) for x, f in
                        zip((kind, op, feat, cval, length), trees))),
            torch.tensor(changed))
