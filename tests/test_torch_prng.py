"""The port's random stream (``utils/rng.py``) against jax 0.9's, bit for
bit, on the CPU: ``threefry2x32`` in partitionable mode, ``PRNGKey``,
``split``, ``fold_in`` and ``random_bits`` at every width, every sampler
the JAX package calls in float32, bfloat16, float16 and float64 (float64
under ``jax.enable_x64()``; the port's draws take their dtype from the
caller), and XLA's CPU ``log``, ``log1p`` and ``erf_inv`` over the whole
float32 lattice of ``uniform`` (the float math of ``gumbel`` and
``normal``). The literals that
``chip_smoke.py`` holds the threefry kernel to on the card, where there is
no JAX, are checked against JAX here. On a CUDA tensor every function
launches the threefry kernel or raises, never its plain version, and no
module of the search path holds a ``torch.Generator``."""

import ast
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from symbolicregression_jl_tpu_torch.ops import kernel_rng
from symbolicregression_jl_tpu_torch.utils import rng

REPO = pathlib.Path(__file__).resolve().parents[1]
N_KEYS = 100_000

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16, torch.float64: jnp.float64}


def _keys(n, seed=0):
    """n random uint32 key pairs, the first few at the edges (0, 2^31,
    2^32 - 1)."""
    k = np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2),
                                             dtype=np.uint64)
    k[:6] = [[0, 0], [0, 1], [2 ** 31, 0], [2 ** 32 - 1, 2 ** 32 - 1],
             [2 ** 31 - 1, 2 ** 31], [12345, 2 ** 32 - 7]]
    return k.astype(np.uint32), torch.from_numpy(k.astype(np.int64))


def _same(ref, got):
    """Bit equality of a JAX result and a port tensor (floats compared by
    their bit patterns, bfloat16 by its 16 bits)."""
    ref = np.asarray(ref)
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16).numpy().view(np.uint16)
        ref = ref.view(np.uint16)
    else:
        got = got.numpy()
    if ref.dtype.kind == "f":
        width = {2: np.uint16, 4: np.uint32, 8: np.uint64}[ref.itemsize]
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.view(width), ref.view(width))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      ref.astype(np.int64))


# ---------------------------------------------------------------------------
# Keys and bits
# ---------------------------------------------------------------------------


def test_threefry2x32_is_jaxs_hash():
    g = np.random.default_rng(1)
    k1, k2, x1, x2 = (g.integers(0, 2 ** 32, N_KEYS, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    ref = jprng.threefry2x32_p.bind(*(jnp.asarray(a) for a in (k1, k2, x1,
                                                               x2)))
    got = rng.threefry2x32(k1, k2, x1, x2)
    for r, t in zip(ref, got):
        np.testing.assert_array_equal(t, np.asarray(r))


@pytest.mark.parametrize("x64", [False, True], ids=["x32", "x64"])
def test_prng_key_of_every_seed_kind(x64):
    seeds = [0, 1, 42, -1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, -2 ** 31,
             2 ** 40 + 3, 7919 * 3 + 11]
    with jax.enable_x64(x64):
        for s in seeds:
            np.testing.assert_array_equal(
                rng.key(s, x64=x64).numpy(),
                np.asarray(jax.random.PRNGKey(s)).astype(np.int64), str(s))


@pytest.mark.parametrize("n", [1, 2, 3, 6, 10])
def test_split_is_jaxs_split(n):
    jk, tk = _keys(N_KEYS // n)
    _same(jax.vmap(lambda k: jax.random.split(k, n))(jnp.asarray(jk)),
          rng.split(tk, n))


def test_split_keeps_leading_shapes_and_strided_keys():
    """A batch of keys of any leading shape, and a strided view (a
    ``split(...)[..., i, :]``), split as the vmapped reference does."""
    jk, tk = _keys(60)
    jk, tk = jk.reshape(3, 4, 5, 2), tk.reshape(3, 4, 5, 2)
    ref = jax.vmap(jax.vmap(jax.vmap(lambda k: jax.random.split(k, 4))))(
        jnp.asarray(jk))
    _same(ref, rng.split(tk, 4))
    sub = rng.split(tk, 6)[..., 2, :]
    _same(jax.vmap(jax.vmap(jax.vmap(lambda k: jax.random.split(k, 6)[2])))(
        jnp.asarray(jk)), sub)
    _same(jax.vmap(jax.vmap(jax.vmap(lambda k: jax.random.split(
        jax.random.split(k, 6)[2], 3))))(jnp.asarray(jk)), rng.split(sub, 3))


@pytest.mark.parametrize("data", [0, 7, 0x5F3759DF, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_is_jaxs_fold_in(data):
    jk, tk = _keys(N_KEYS // 5)
    _same(jax.vmap(lambda k: jax.random.fold_in(k, data))(jnp.asarray(jk)),
          rng.fold_in(tk, data))


@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_random_bits_every_width(width):
    jk, tk = _keys(4000)
    dt = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32, 64: jnp.uint64}[width]
    with jax.enable_x64(width == 64):
        ref = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (3, 5), dt))(
            jnp.asarray(jk)))
    got = rng.random_bits(tk, width, (3, 5))
    if width == 64:
        ref = ref.view(np.int64)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
IDS = ["f32", "bf16", "f16", "f64"]


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_float_samplers_every_dtype(dtype):
    """uniform (default and bounded), normal, gumbel and bernoulli."""
    x64 = dtype == torch.float64
    jdt = JDT[dtype]
    jk, tk = _keys(3000, 2)
    J = jnp.asarray(jk)
    with jax.enable_x64(x64):
        _same(jax.vmap(lambda k: jax.random.uniform(k, (7,), jdt))(J),
              rng.uniform(tk, (7,), dtype))
        _same(jax.vmap(lambda k: jax.random.uniform(k, (7,), jdt, -0.75,
                                                    3.25))(J),
              rng.uniform(tk, (7,), dtype, -0.75, 3.25))
        _same(jax.vmap(lambda k: jax.random.normal(k, (7,), jdt))(J),
              rng.normal(tk, (7,), dtype))
        _same(jax.vmap(lambda k: jax.random.gumbel(k, (7,), jdt))(J),
              rng.gumbel(tk, (7,), dtype))
        p = np.asarray(0.3, dtype=np.float64 if x64 else np.float32)
        _same(jax.vmap(lambda k: jax.random.bernoulli(
            k, jnp.asarray(p, jdt), (7,)))(J),
            rng.bernoulli(tk, torch.tensor(float(p), dtype=dtype), (7,)))


@pytest.mark.parametrize("x64", [False, True], ids=["x32", "x64"])
def test_default_dtype_draws_follow_x64(x64):
    """A draw whose dtype JAX leaves to its default (a Python-float p, no
    dtype) is a float32 draw, or under x64 a float64 one of 64 bits: the
    port's ``draw_dtype`` of the search's working dtype (float64 for the
    reference's x64 search, float32 for every other precision)."""
    jk, tk = _keys(2000, 3)
    for working in ((torch.float64,) if x64 else
                    (torch.float32, torch.bfloat16, torch.float16)):
        fd = rng.draw_dtype(working)
        with jax.enable_x64(x64):
            _same(jax.vmap(lambda k: jax.random.bernoulli(k, 0.37, (9,)))(
                jnp.asarray(jk)), rng.bernoulli(tk, 0.37, (9,), fd))
            _same(jax.vmap(lambda k: jax.random.uniform(k, (9,)))(
                jnp.asarray(jk)), rng.uniform(tk, (9,), fd))
    assert rng.uniform(tk[:3], (2,)).dtype == torch.float32


@pytest.mark.parametrize("bounds", [(0, 1000), (1, 7), (-5, 2 ** 31 - 1),
                                    (3, 3), (4, 2)])
def test_randint_static_bounds(bounds):
    jk, tk = _keys(3000, 4)
    lo, hi = bounds
    _same(jax.vmap(lambda k: jax.random.randint(k, (6,), lo, hi, jnp.int32))(
        jnp.asarray(jk)), rng.randint(tk, (6,), lo, hi))


def test_randint_with_a_traced_bound():
    """The reference's randomize branch draws with a traced maxval; the
    port's bound is a tensor, per key or one scalar."""
    jk, tk = _keys(3000, 5)
    hi = np.random.default_rng(6).integers(2, 40, 3000).astype(np.int32)
    _same(jax.vmap(lambda k, h: jax.random.randint(k, (), 1, h, jnp.int32))(
        jnp.asarray(jk), jnp.asarray(hi)),
        rng.randint(tk, (), 1, torch.from_numpy(hi.astype(np.int64))))
    _same(jax.jit(jax.vmap(lambda k, h: jax.random.randint(
        k, (), 1, h, jnp.int32), in_axes=(0, None)))(jnp.asarray(jk),
                                                      jnp.int32(13)),
        rng.randint(tk, (), 1, torch.tensor(13)))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_categorical_every_dtype(dtype):
    x64 = dtype == torch.float64
    jk, tk = _keys(3000, 7)
    g = np.random.default_rng(8)
    logits = g.standard_normal((3000, 9))
    masked = np.where(g.random((3000, 12)) < 0.3, 0.0, -1e9)
    with jax.enable_x64(x64):
        for lg in (logits, masked):
            jl = jnp.asarray(lg, JDT[dtype])
            tl = torch.from_numpy(np.asarray(jl).astype(np.float64)).to(dtype)
            _same(jax.vmap(jax.random.categorical)(jnp.asarray(jk), jl),
                  rng.categorical(tk, tl))
        one = jnp.asarray(logits[:1, :6], JDT[dtype])
        _same(jax.random.categorical(jnp.asarray(jk[0]), one, shape=(5, 40)),
              rng.categorical(tk[0], torch.from_numpy(
                  np.asarray(one).astype(np.float64)).to(dtype), (5, 40)))


@pytest.mark.parametrize("npop", [33, 1000, 1700])
def test_choice_without_replacement_and_permutation(npop):
    """``choice(replace=False)`` (the tournaments) and ``permutation``:
    one stable-sort round up to npop 1,625, two above."""
    jk, tk = _keys(200, 9)
    J = jnp.asarray(jk)
    _same(jax.vmap(lambda k: jax.random.choice(k, npop, (7,),
                                               replace=False))(J),
          rng.choice_without_replacement(tk, npop, 7))
    _same(jax.vmap(lambda k: jax.random.permutation(k, npop))(J[:20]),
          rng.permutation(tk[:20], npop))


def test_top_k_takes_the_lower_index_among_ties():
    x = np.round(np.random.default_rng(10).random((40, 50)) * 4) / 4
    _same(jax.lax.top_k(jnp.asarray(x, jnp.float32), 12)[1],
          rng.top_k_indices(torch.from_numpy(x.astype(np.float32)), 12))


# ---------------------------------------------------------------------------
# XLA's float math over the whole float32 lattice of uniform
# ---------------------------------------------------------------------------


def _lattice():
    """The 2^23 float32 values of ``uniform`` in [0, 1)."""
    bits = np.arange(1 << 23, dtype=np.uint32) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def test_gumbel_math_over_the_lattice():
    """-log(-log(u)) for every u that ``uniform(tiny, 1)`` can give: the
    gumbel epilogue's log is XLA's CPU log bit for bit (torch's own
    differs in the last bit at 14 % of the lattice)."""
    tiny = np.float32(np.finfo(np.float32).tiny)
    u = np.maximum(tiny, _lattice() + tiny)
    ref = np.asarray(jax.jit(lambda v: -jnp.log(-jnp.log(v)))(u))
    got = -rng._log_f32(-rng._log_f32(u))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_normal_math_over_the_lattice():
    """sqrt(2) * erf_inv(u) and log1p(-u^2) for every u that
    ``uniform(nextafter(-1, 0), 1)`` can give."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, _lattice() * np.float32(2) + lo)
    ref = np.asarray(jax.jit(lambda v: np.float32(np.sqrt(2))
                             * jax.lax.erf_inv(v))(u))
    got = np.float32(rng._SQRT2_F32) * rng._erfinv_f32(u)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    a = -(u * u)
    np.testing.assert_array_equal(
        rng._log1p_f32(a).view(np.uint32),
        np.asarray(jax.jit(jnp.log1p)(a)).view(np.uint32))


def test_fma_is_rounded_once():
    """``utils.fma.fma`` (the uniform epilogue's and B2's fused L2 sum's
    plain versions) against exact rational arithmetic."""
    from fractions import Fraction
    from symbolicregression_jl_tpu_torch.utils.fma import fma
    g = np.random.default_rng(11)
    a, b, c = (g.standard_normal(500).astype(np.float32) * s
               for s in (1.0, 3.0, 1e-3))
    got = fma(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for i in range(500):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        assert got[i] == np.float32(float(exact)) or abs(
            Fraction(float(got[i])) - exact) <= abs(
            Fraction(float(np.float32(float(exact)))) - exact), i


# ---------------------------------------------------------------------------
# chip_smoke.py's frozen literals, the kernel's dispatch, no generators
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_literals_are_jaxs():
    """Every value ``chip_smoke.JAX_LITERALS`` holds the card's kernel to
    is what jax 0.9 gives on the CPU."""
    lit = _chip_smoke().JAX_LITERALS
    key = jax.random.PRNGKey(lit["seed"])
    np.testing.assert_array_equal(np.asarray(key).astype(np.int64),
                                  lit["key"])
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(key, 4)).astype(np.int64), lit["split4"])
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(key, 0x5F3759DF)).astype(np.int64),
        lit["fold_in"])
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, (8,), jnp.uint32)).astype(np.int64),
        lit["bits32"])
    for name, fn in (("uniform", jax.random.uniform),
                     ("normal", jax.random.normal),
                     ("gumbel", jax.random.gumbel)):
        np.testing.assert_array_equal(
            np.asarray(fn(key, (8,), jnp.float32)).view(np.uint32).astype(
                np.int64), lit[name + "_bits"])
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(key, (8,), 0, 1000, jnp.int32)),
        lit["randint"])
    np.testing.assert_array_equal(
        np.asarray(jax.random.choice(key, 33, (6,), replace=False)),
        lit["choice"])


def test_a_cuda_tensor_never_takes_the_plain_threefry(monkeypatch):
    """Keys on the card go to the kernel's wrappers (here without a card
    the library cannot load, so the wrapper raises), never to the plain
    version; the plain hash refuses CUDA tensors."""

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    keys = rng.key(1).as_subclass(OnCard)

    def no_library():
        raise RuntimeError("kernel launch attempted")

    monkeypatch.setattr(kernel_rng, "_library", no_library)
    monkeypatch.setattr(kernel_rng, "_flat_keys",
                        lambda k: (k, 1, 2))
    for call in (lambda: rng.split(keys, 3), lambda: rng.fold_in(keys, 5),
                 lambda: rng.random_bits(keys, 32, (4,)),
                 lambda: rng.uniform(keys, (4,)),
                 lambda: rng.normal(keys, (4,)),
                 lambda: rng.gumbel(keys, (4,)),
                 lambda: rng.randint(keys, (4,), 0, 9),
                 lambda: rng.categorical(keys, torch.zeros(5))):
        with pytest.raises(RuntimeError, match="kernel launch attempted"):
            call()
    with pytest.raises(RuntimeError, match="CPU tensors only"):
        rng._hash(keys, (2,))


def test_no_torch_generator_on_the_search_path():
    """No module that ``api``, ``models`` or ``parallel`` holds builds or
    takes a ``torch.Generator``: every draw of the search is keyed."""
    pkg = REPO / "symbolicregression_jl_tpu_torch"
    files = [pkg / "api.py", *sorted((pkg / "models").glob("*.py")),
             *sorted((pkg / "parallel").glob("*.py")),
             pkg / "utils" / "rng.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("Generator", "manual_seed",
                                         "get_state", "set_state"), (
                    f"{path.name}:{node.lineno} {node.attr}")
            if isinstance(node, ast.keyword):
                assert node.arg != "generator", f"{path.name}:{node.lineno}"
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "torch"):
                assert node.func.attr not in ("rand", "randn", "randint",
                                              "randperm", "multinomial",
                                              "bernoulli", "normal_",
                                              "uniform_"), (
                    f"{path.name}:{node.lineno} torch.{node.func.attr}")
