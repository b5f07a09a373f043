"""Every random draw of the port goes through this module.

The JAX package splits a threefry key per island and vmaps; here one
``torch.Generator`` on the search's device draws whole batches at once, so
the island axis is just the leading dimension of each draw. The draws
differ from JAX's (stochastic modules are held by invariants and at search
level); a key-compatible generator can later replace these functions
without touching their callers.

No function here synchronises with the host.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) float32."""
    return torch.rand(shape, generator=gen, device=device)


def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def randint(gen: torch.Generator, shape, low: int, high: int,
            device) -> torch.Tensor:
    """Integers in [low, high)."""
    return torch.randint(int(low), int(high), shape, generator=gen,
                         device=device)


def bernoulli(gen: torch.Generator, p, shape, device) -> torch.Tensor:
    """Bool draws with probability ``p`` (a float or a tensor)."""
    return uniform(gen, shape, device) < p


def choice_mask(gen: torch.Generator, mask: torch.Tensor) -> torch.Tensor:
    """Uniform index along the last axis among positions where ``mask`` is
    True (index 0 where none is). The argmax of i.i.d. uniforms restricted
    to the mask is a uniform pick."""
    u = uniform(gen, mask.shape, mask.device)
    return torch.argmax(torch.where(mask, u, -1.0), dim=-1)


def categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Sample along the last axis by the Gumbel-max trick (``-inf`` logits
    are never drawn unless every logit is ``-inf``)."""
    u = uniform(gen, logits.shape, logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample_without_replacement(gen: torch.Generator, batch_shape, n: int,
                               k: int, device) -> torch.Tensor:
    """``k`` distinct indices in [0, n) for every batch element: the k
    smallest of n i.i.d. uniforms (a uniformly random k-subset)."""
    u = uniform(gen, tuple(batch_shape) + (n,), device)
    return torch.topk(u, k, dim=-1, largest=False).indices
