"""gomavatar_tpu_torch.prng against jax.random on the CPU (threefry2x32,
``jax_threefry_partitionable`` on: JAX's defaults).

Reached: ``key``, ``split``, ``bits``, ``uniform`` and ``normal`` are equal
to jax.random's bit for bit on every case here.  For ``normal`` that takes
XLA's CPU float32 ``log1p`` (a Cephes rational where |x| < sqrt(2) - 1, else
XLA's Cephes ``log`` of 1 + x) and erfinv polynomial, with their
multiply-adds rounded once as XLA's CPU code fuses them; numpy's own
``log1p`` would leave ~1 % of the values one float32 ulp away (2.4e-7
relative).  The committed witness (``weights/prng_witness.npz``), which
``chip_smoke.py`` checks the port's draws against on the card's host where
there is no JAX, is held equal to JAX's draws here; only
``tests/torch_prng_witness.py`` writes it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.tools import prng_witness as W
from torch_prng_witness import witness

SEEDS = [0, 1, 7, 1234, 4321, 2**31 - 1]
SHAPES = [(), (1,), (5, 7), (3, 3, 3, 64), (257, 300)]  # the last past 2**16 values


def assert_bits_equal(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    k = prng.key(seed)
    assert_bits_equal(k, jax.random.PRNGKey(seed))
    for num in (2, 3, 7):
        assert_bits_equal(prng.split(k, num), jax.random.split(jax.random.PRNGKey(seed), num))
    # a chain of splits, as the LPIPS inits walk it
    jk, pk = jax.random.PRNGKey(seed), k
    for _ in range(5):
        jk, _ = jax.random.split(jk)
        pk, _ = prng.split(pk)
    assert_bits_equal(pk, jk)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_bit_for_bit(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    assert_bits_equal(prng.bits(k, shape), jax.random.bits(jk, shape))
    assert_bits_equal(prng.uniform(k, shape), jax.random.uniform(jk, shape))
    # xavier-style symmetric limits, as nn.linear_init draws them
    lim = np.float32(np.sqrt(2.0) * np.sqrt(6.0 / 138))
    assert_bits_equal(prng.uniform(k, shape, -lim, lim), jax.random.uniform(jk, shape, jnp.float32, -lim, lim))
    assert_bits_equal(prng.normal(k, shape), jax.random.normal(jk, shape))


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), shape=st.lists(st.integers(0, 9), min_size=0, max_size=3).map(tuple))
def test_draws_bit_for_bit_hypothesis(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    assert_bits_equal(prng.split(k, 4), jax.random.split(jk, 4))
    assert_bits_equal(prng.bits(k, shape), jax.random.bits(jk, shape))
    assert_bits_equal(prng.uniform(k, shape, -1e-5, 1e-5), jax.random.uniform(jk, shape, jnp.float32, -1e-5, 1e-5))
    assert_bits_equal(prng.normal(k, shape), jax.random.normal(jk, shape))


def test_key_refuses_seeds_outside_int32():
    for seed in (-1, 2**31):
        with pytest.raises(ValueError):
            prng.key(seed)


@pytest.fixture(scope="module")
def committed():
    with np.load(W.WITNESS) as z:
        return {k: z[k] for k in z.files}


def test_committed_witness_is_jaxs_draws(committed):
    want = witness()
    assert sorted(committed) == sorted(want)
    for k in want:
        assert_bits_equal(committed[k], want[k])


def test_port_draws_equal_the_committed_witness():
    assert W.mismatches() == []
    assert W.WITNESS.stat().st_size < 64 * 1024
