"""Shared fixtures for the PyTorch-port parity tests: the same numpy inputs,
made from a seed, go to the JAX package and to the port."""

import numpy as np
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.utils.random_exprs import random_expr_fixed_size
from symbolicregression_jl_tpu_torch import convert

# one thread per test process: the suite runs several worker processes side by side
torch.set_num_threads(1)

L = 24


def jax_trees(rng, ops, n, nfeat, max_size=22, min_size=1, exprs=()):
    """A JAX TreeBatch of n random trees (plus any extra Exprs)."""
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
