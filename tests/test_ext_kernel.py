"""The CMux step's implementations and the choice between them.

The Hopper external-product kernel runs here in Pallas interpret mode
against the plain XLA step; the plain step runs against a NumPy
schoolbook negacyclic product that shares no code with it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ieache import params as P
from ieache.ops import blind_rotate as br
from ieache.ops import pallas_kernels as pk
from ieache.params import TFHEParams


def _random_step(p: TFHEParams, b: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    half = 1 << (p.bg_bit - 1)
    d = rng.integers(-half, half, (b, p.trgsw_rows, p.N)).astype(np.int32)
    bk = rng.integers(-2**31, 2**31,
                      (p.trgsw_rows, p.k + 1, p.N)).astype(np.int32)
    return d, bk


def _plain_product(d, bk, p):
    """The plain step's contraction alone: (B, rows, N) x BK step."""
    g = br.make_step_gmatrix(jnp.asarray(bk), p)
    d8 = jnp.asarray(d).astype(jnp.int8)
    out = jnp.zeros((d.shape[0], p.k + 1, p.N), jnp.int32)
    for v in range(4):
        out = out + (br._dot_digits_g(d8, g[v]) << (8 * v))
    return np.asarray(out)


def _schoolbook(d, bk):
    """sum_p d[:, p] * bk[p, o] in Z[X]/(X^N + 1), mod 2^32, by the
    O(N^2) definition."""
    b, rows, n = d.shape
    kp1 = bk.shape[1]
    out = np.zeros((b, kp1, n), np.int64)
    for p_ in range(rows):
        for o in range(kp1):
            g = bk[p_, o].astype(np.int64)
            for m in range(n):
                # X^m * g: coefficient j gets g[j - m], negated on wrap
                rolled = np.roll(g, m)
                rolled[:m] *= -1
                out[:, o] += d[:, p_, m:m + 1].astype(np.int64) * rolled
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("b", [1, 7, 8, 64, 200, 1056])
def test_kernel_interpret_matches_plain_step(b, l, n):
    p = TFHEParams(n=4, N=n, l=l, name="kernel_test")
    d, bk = _random_step(p, b, seed=b * 10 + l)
    got = np.asarray(pk.external_product(
        jnp.asarray(d), jnp.asarray(bk), p, interpret=True))
    assert got.shape == (b, p.k + 1, n)
    np.testing.assert_array_equal(got, _plain_product(d, bk, p))


@pytest.mark.parametrize("p", [
    P.TEST_TINY,
    TFHEParams(n=4, N=64, l=3, name="l3_n64"),
    TFHEParams(n=4, N=64, bg_bit=10, l=2, name="compat_n64"),
], ids=lambda p: p.name)
def test_plain_step_matches_schoolbook(p):
    """One whole plain CMux step, acc + BK ⊡ digits(X^a·acc − acc),
    against the schoolbook product of the same digits (the two-limb
    compat gadget included)."""
    rng = np.random.default_rng(3)
    b = 3
    acc = rng.integers(-2**31, 2**31, (b, p.k + 1, p.N)).astype(np.int32)
    bara = rng.integers(0, 2 * p.N, (b,)).astype(np.int32)
    _, bk = _random_step(p, b)
    got = np.asarray(br.external_product_step(
        jnp.asarray(acc), jnp.asarray(bara), jnp.asarray(bk), p))
    d = np.asarray(br._step_digits(jnp.asarray(acc), jnp.asarray(bara), p))
    want = (acc.astype(np.int64) + _schoolbook(d, bk)).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_kernel_blind_rotation_matches_plain():
    """A whole blind rotation with the kernel (interpret mode) ends on
    the plain path's accumulator bit for bit."""
    p = P.TEST_TINY
    rng = np.random.default_rng(5)
    b = 5
    acc0 = jnp.asarray(
        rng.integers(-2**31, 2**31, (b, p.k + 1, p.N)).astype(np.int32))
    bara = jnp.asarray(rng.integers(0, 2 * p.N, (b, p.n)).astype(np.int32))
    bk = jnp.asarray(rng.integers(
        -2**31, 2**31, (p.n, p.trgsw_rows, p.k + 1, p.N)).astype(np.int32))
    want = br.blind_rotate(acc0, bara, bk, p, impl="plain")
    got = br.blind_rotate(acc0, bara, bk, p, impl="interpret")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("backend,params,env,want", [
    ("cpu", P.IEACHE_110, None, "plain"),
    ("gpu", P.IEACHE_110, None, "kernel"),
    ("gpu", P.IEACHE_110_FAST, None, "kernel"),
    ("gpu", P.IEACHE_110_TFHE_COMPAT, None, "plain"),
    ("gpu", P.IEACHE_110, "plain", "plain"),
    ("gpu", P.IEACHE_110, "ntt", "ntt"),
    ("cpu", P.TEST_TINY, "ntt", "ntt"),
    ("cpu", P.IEACHE_110, "kernel", "kernel"),
])
def test_step_choice(monkeypatch, backend, params, env, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if env:
        monkeypatch.setenv("IEACHE_STEP", env)
    else:
        monkeypatch.delenv("IEACHE_STEP", raising=False)
    assert br.step_impl(params) == want


def test_step_choice_is_plain_inside_shard_map(monkeypatch):
    from jax.sharding import Mesh, PartitionSpec as PS

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("IEACHE_STEP", raising=False)
    seen = []

    def body(x):
        seen.append(br.step_impl(P.IEACHE_110))
        return x

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    jax.jit(jax.shard_map(body, mesh=mesh, in_specs=PS("dp"),
                          out_specs=PS("dp")))(jnp.zeros(4))
    assert seen == ["plain"]


@pytest.mark.parametrize("env,params", [
    ("ntt", P.IEACHE_110_TFHE_COMPAT),
    ("kernel", P.IEACHE_110_TFHE_COMPAT),
    ("fast", P.IEACHE_110),
])
def test_step_request_refused(monkeypatch, env, params):
    monkeypatch.setenv("IEACHE_STEP", env)
    with pytest.raises(ValueError, match="IEACHE_STEP"):
        br.step_impl(params)


@pytest.mark.parametrize("b", [1, 8, 16, 17, 64, 65, 200, 256, 1024, 1056])
def test_tiles_fit_batch_and_params(b):
    for p in (P.IEACHE_110, P.IEACHE_110_FAST, P.TEST_TINY):
        t = pk.pick_tiles(b, p)
        assert t.bm >= 16 and t.bm & (t.bm - 1) == 0
        assert p.N % t.bn == 0 and p.N % t.bk == 0
        assert (p.trgsw_rows * p.N // t.bk) % t.split == 0
        # the padded batch wastes less than one block
        assert -(-b // t.bm) * t.bm - b < t.bm
        assert t.bm * t.bn * 4 // (32 * t.num_warps) <= 128  # acc regs


def test_kernel_rejects_two_limb_gadget_and_bad_tiles():
    p = TFHEParams(n=4, N=64, bg_bit=10, l=2, name="compat_n64")
    d, bk = _random_step(p, 2)
    with pytest.raises(ValueError, match="single-limb"):
        pk.external_product(jnp.asarray(d), jnp.asarray(bk), p,
                            interpret=True)
    p = P.TEST_TINY
    d, bk = _random_step(p, 2)
    with pytest.raises(ValueError, match="do not divide"):
        pk.external_product(jnp.asarray(d), jnp.asarray(bk), p,
                            interpret=True,
                            tiles=pk.Tiles(bm=16, bn=64, bk=64, split=3))


def test_kernel_keeps_a_dp_sharded_batch_sharded(monkeypatch):
    """Under a jit over a dp-sharded batch, each device runs the kernel
    on its own lanes and the product stays sharded."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    p = TFHEParams(n=4, N=64, l=2, name="dp_kernel")
    d, bk = _random_step(p, 32, seed=9)
    seen = []
    real = pk._product
    monkeypatch.setattr(pk, "_product", lambda d8, *a: seen.append(
        d8.shape[0]) or real(d8, *a))
    pk._batch_partitioned.cache_clear()
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    d_sh = jax.device_put(jnp.asarray(d), NamedSharding(mesh, PS("dp")))
    f = jax.jit(lambda x, y: pk.external_product(x, y, p, interpret=True))
    got = f(d_sh, jnp.asarray(bk))
    pk._batch_partitioned.cache_clear()
    np.testing.assert_array_equal(np.asarray(got), _plain_product(d, bk, p))
    assert 8 in seen                      # traced on one device's lanes
    assert {s.data.shape[0] for s in got.addressable_shards} == {8}


def test_lanes_above_the_kernel_limit_take_the_plain_product(monkeypatch):
    p = TFHEParams(n=4, N=64, l=2, name="many_lanes")
    b = pk.KERNEL_MAX_LANES + 8
    d, bk = _random_step(p, b, seed=4)
    launches = []
    real = pk._launch
    monkeypatch.setattr(pk, "_launch", lambda *a: launches.append(
        a[0].shape[0]) or real(*a))
    pk._batch_partitioned.cache_clear()
    got = pk.external_product(jnp.asarray(d), jnp.asarray(bk), p,
                              interpret=True)
    pk._batch_partitioned.cache_clear()
    np.testing.assert_array_equal(np.asarray(got), _plain_product(d, bk, p))
    assert launches == []
