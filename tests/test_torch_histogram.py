"""Port parity: ``repro_torch.core.histogram`` against ``repro.core``.

The same NumPy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart (on the CPU, where the port's kernels run their
plain versions).  Tolerances: boundaries, sizes and cuts bit-equal
(``np.array_equal``, dtype included); interpolation outputs ``rtol=1e-6``
(the two frameworks may fuse ``a + (d/dx)·df`` differently); the μ metrics
``rtol=1e-6`` (reduction order).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (seed, k, T, beta, duplicate-heavy): the golden merge cases of
# tests/test_merge_kernel_parity.py
GOLDEN = [
    (0, 1, 4, 2, False),
    (1, 3, 16, 16, False),
    (2, 7, 15, 5, False),
    (3, 2, 8, 1, False),
    (4, 3, 41, 12, True),
    (5, 5, 12, 7, True),
    (6, 1, 7, 7, True),
    (7, 4, 20, 19, False),
]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a, b), (a, b)


def assert_same_hist(hr, hp):
    assert_same(hr.boundaries, hp.boundaries)
    assert_same(hr.sizes, hp.sizes)


def golden_sources(seed, k, T, dup):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(T, 400))
        if dup:
            v = rng.integers(0, 8, size=n).astype(np.float32)
        else:
            v = (rng.normal(size=n) * 5).astype(np.float32)
        out.append(v)
    return out


def stacked(ref_hists):
    b = np.stack([np.asarray(h.boundaries) for h in ref_hists])
    s = np.stack([np.asarray(h.sizes) for h in ref_hists])
    return R.Histogram(jnp.asarray(b), jnp.asarray(s)), P.Histogram(b, s)


def test_import_gate_in_a_fresh_interpreter():
    code = (
        "import sys; import repro_torch; import repro_torch.core; "
        "import repro_torch.kernels; import repro_torch.convert; "
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules, "
        "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
        "from repro_torch.kernels import _lib; "
        "assert _lib._LIBS == {}, 'importing built or loaded a kernel'"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
    )
    assert out.returncode == 0, out.stderr


def test_port_sources_import_neither_jax_nor_the_reference():
    roots = [os.path.join(REPO, "src", "repro_torch"), os.path.join(REPO, "chip_smoke.py")]
    bad = []
    for root in roots:
        paths = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")
        ]
        for path in paths:
            with open(path) as f:
                for no, line in enumerate(f, 1):
                    s = line.strip()
                    if s.startswith(("import jax", "from jax", "import repro ", "from repro.")) or s in (
                        "import repro",
                    ):
                        bad.append(f"{path}:{no}: {s}")
    assert not bad, bad


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("n,T", [(1, 1), (7, 7), (100, 16), (1000, 64), (777, 5)])
def test_build_exact_bit_equal(dtype, n, T):
    rng = np.random.default_rng(n * 31 + T)
    if np.issubdtype(dtype, np.integer):
        v = rng.integers(-40, 40, size=n).astype(dtype)
    else:
        v = (rng.normal(size=n) * 50).astype(dtype)
    assert_same_hist(R.build_exact(jnp.asarray(v), T), P.build_exact(v, T))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
def test_build_exact_padded_batched_ragged(dtype):
    rng = np.random.default_rng(5)
    T = 16
    lens = [16, 17, 40, 63, 64]
    rows, ns = [], []
    for n in lens:
        if np.issubdtype(dtype, np.integer):
            v = rng.integers(-9, 9, size=n).astype(np.int32 if dtype == np.int64 else dtype)
        else:
            v = (rng.normal(size=n)).astype(np.float32 if dtype == np.float64 else dtype)
        padded, _ = R.pad_pow2(v, min_len=64)
        rows.append(padded)
        ns.append(n)
    stack = np.stack(rows)
    hr = R.build_exact_padded_batched(jnp.asarray(stack), np.asarray(ns, np.int32), T)
    hp = P.build_exact_padded_batched(stack, ns, T)
    assert_same_hist(hr, hp)
    for i, n in enumerate(lens):  # and each row equals the unpadded build
        assert_same_hist(R.build_exact(jnp.asarray(stack[i, :n]), T), P.Histogram(hp.boundaries[i], hp.sizes[i]))
    one_r = R.build_exact_padded(jnp.asarray(stack[2]), ns[2], T)
    assert_same_hist(one_r, P.build_exact_padded(stack[2], ns[2], T))


def test_build_exact_batched_and_pad_pow2():
    v = np.random.default_rng(6).normal(size=(3, 50)).astype(np.float32)
    assert_same_hist(R.build_exact_batched(jnp.asarray(v), 8), P.build_exact_batched(v, 8))
    for n in (1, 5, 64, 65):
        a, na = R.pad_pow2(np.arange(n, dtype=np.int32), min_len=8)
        b, nb = P.pad_pow2(np.arange(n, dtype=np.int32), min_len=8)
        assert na == nb and np.array_equal(a, b) and a.dtype == b.dtype
    with pytest.raises(ValueError):
        P.build_exact(np.zeros(0, np.float32), 4)


@pytest.mark.parametrize("seed,k,T,beta,dup", GOLDEN)
def test_merge_golden_bit_equal(seed, k, T, beta, dup):
    srcs = golden_sources(seed, k, T, dup)
    hr, hp = stacked([R.build_exact(jnp.asarray(v), T) for v in srcs])
    mr, mp = R.merge(hr, beta), P.merge(hp, beta)
    assert_same_hist(mr, mp)
    pr, pp = R.pre_histogram(hr), P.pre_histogram(hp)
    assert_same(pr[0], pp[0])
    assert_same(pr[1], pp[1])
    sr = R.merge_histograms_sequential([R.build_exact(jnp.asarray(v), T) for v in srcs], beta)
    sp = P.merge_histograms_sequential([P.build_exact(v, T) for v in srcs], beta)
    assert_same_hist(sr, sp)


@pytest.mark.parametrize("seed", range(4))
def test_merge_random_and_merge_list(seed):
    rng = np.random.default_rng(100 + seed)
    # few distinct shapes: each one is a fresh JAX compile
    Ts = [int(t) for t in rng.choice([8, 16, 24], size=int(rng.integers(2, 6)))]
    srcs = [(rng.gumbel(size=int(rng.choice([200, 333]))) * 10).astype(np.float32) for _ in Ts]
    beta = int(rng.integers(1, 50))
    hr = [R.build_exact(jnp.asarray(v), t) for v, t in zip(srcs, Ts)]
    hp = [P.build_exact(v, t) for v, t in zip(srcs, Ts)]
    assert_same_hist(R.merge_list(hr, beta), P.merge_list(hp, beta))
    # integer summaries keep int32 boundaries through merge_list
    ir = [R.build_exact(jnp.asarray(v.astype(np.int32)), t) for v, t in zip(srcs, Ts)]
    ip = [P.build_exact(v.astype(np.int32), t) for v, t in zip(srcs, Ts)]
    assert_same_hist(R.merge_list(ir, beta), P.merge_list(ip, beta))


def test_merge_above_2_pow_24_records_what_differs():
    """Total mass 3·2^23 + ... > 2^24: float32 cumulative sums round, and
    XLA's cumsum and torch's round in another order.  What differs here:
    no boundary, and 3 of the 16 sizes, each by at most 2 ulp of the total
    (32 of 25,165,846 values).  What is held, in both packages: Theorem 1
    on the reported sizes and mass conservation to float32 rounding."""
    rng = np.random.default_rng(24)
    T, beta, k = 64, 16, 4
    b = np.sort(rng.normal(size=(k, T + 1)).astype(np.float32), axis=-1)
    n_src = np.array([2**23 + 13, 2**22 + 7, 2**23 + 1, 2**22 + 5])
    cuts = (np.arange(T + 1)[None, :] * n_src[:, None]) // T
    s = np.diff(cuts, axis=-1).astype(np.float32)
    hr = R.merge(R.Histogram(jnp.asarray(b), jnp.asarray(s)), beta)
    hp = P.merge(P.Histogram(b, s), beta)
    n = float(n_src.sum())
    assert n > 2**24
    ulp = float(np.spacing(np.float32(n)))
    sr, sp = np.asarray(hr.sizes, np.float64), hp.sizes.numpy().astype(np.float64)
    assert np.array_equal(np.asarray(hr.boundaries), hp.boundaries.numpy())
    assert int((sr != sp).sum()) == 3
    assert np.abs(sr - sp).max() <= 2 * ulp
    for sizes in (sr, sp):
        assert abs(sizes.sum() - n) <= beta * ulp
        assert np.abs(sizes - n / beta).max() <= R.theoretical_eps_max(n, T, k, exact_inputs=False)


@pytest.mark.parametrize("beta", [1, 5, 16])
def test_queries_match(beta):
    rng = np.random.default_rng(beta)
    srcs = [rng.gumbel(size=300).astype(np.float32) for _ in range(3)]
    hr, hp = stacked([R.build_exact(jnp.asarray(v), 16) for v in srcs])
    mr, mp = R.merge(hr, beta), P.merge(hp, beta)
    q = np.linspace(0.0, 1.0, 21)
    np.testing.assert_allclose(np.asarray(R.quantile(mr, jnp.asarray(q))), P.quantile(mp, q).numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(R.quantile(mr, 0.5)), float(P.quantile(mp, 0.5)), rtol=1e-6)
    x = np.concatenate([np.linspace(-3, 6, 37), [-100.0, 100.0]]).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(R.cdf_interp(mr, jnp.asarray(x))), P.cdf_interp(mp, x).numpy(), rtol=1e-6
    )
    assert_same(R.cdf_left_collapse(mr, jnp.asarray(x)), P.cdf_left_collapse(mp, x))
    np.testing.assert_allclose(
        np.asarray(R.range_count(mr, jnp.asarray(x[:-1]), jnp.asarray(x[1:]))),
        P.range_count(mp, x[:-1], x[1:]).numpy(), rtol=1e-6, atol=1e-3,
    )
    assert_same(mr.n, mp.n)
    assert_same(mr.cumulative(), mp.cumulative())


def test_quantile_flat_segments_and_integer_boundaries():
    b = np.array([0, 0, 3, 3, 9], np.int32)
    s = np.array([0.0, 5.0, 0.0, 5.0], np.float32)
    hr, hp = R.Histogram(jnp.asarray(b), jnp.asarray(s)), P.Histogram(b, s)
    q = np.linspace(0.0, 1.0, 11)
    np.testing.assert_allclose(np.asarray(R.quantile(hr, jnp.asarray(q))), P.quantile(hp, q).numpy(), rtol=1e-6)
    x = np.array([-1, 0, 1, 3, 4, 9, 10], np.float32)
    np.testing.assert_allclose(np.asarray(R.cdf_interp(hr, jnp.asarray(x))), P.cdf_interp(hp, x).numpy(), rtol=1e-6)


def test_error_metrics_match():
    rng = np.random.default_rng(9)
    v = rng.gumbel(size=4000).astype(np.float32)
    parts = np.split(v, 4)
    exact_r, exact_p = R.build_exact(jnp.asarray(v), 32), P.build_exact(v, 32)
    assert_same_hist(exact_r, exact_p)
    hr, hp = stacked([R.build_exact(jnp.asarray(p), 64) for p in parts])
    mr, mp = R.merge(hr, 32), P.merge(hp, 32)
    for fr, fp in [
        (R.boundary_error(mr, exact_r), P.boundary_error(mp, exact_p)),
        (R.size_error(mr, exact_r), P.size_error(mp, exact_p)),
        (R.empirical_size_error(mr, jnp.asarray(v)), P.empirical_size_error(mp, v)),
    ]:
        np.testing.assert_allclose(float(fr), float(fp), rtol=1e-6)
    assert_same(R.empirical_sizes(jnp.asarray(v), mr.boundaries), P.empirical_sizes(v, mp.boundaries))
    assert R.theoretical_eps_max(4000, 64, 4, False) == P.theoretical_eps_max(4000, 64, 4, False)


def test_sample_histogram_held_to_its_bound():
    """The paper's `tuple` baseline: edges included, mass scaled back to N,
    and — as the reference's system test shows — the merge beats it."""
    rng = np.random.default_rng(3)
    v = rng.gumbel(size=20_000).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    h = P.sample_histogram(v, 16, 512, g)
    assert float(h.boundaries[0]) == float(v.min())
    assert float(h.boundaries[-1]) == float(v.max())
    np.testing.assert_allclose(float(h.n), 20_000, rtol=0.02)
    assert np.all(np.diff(h.boundaries.numpy()) >= 0)
    merged = P.merge(P.Histogram(*[torch.stack(x) for x in zip(*[
        P.build_exact(p, 128) for p in np.split(v, 4)
    ])]), 16)
    assert float(P.empirical_size_error(merged, v)) < float(P.empirical_size_error(h, v))
    # the reference's draw differs (jax.random vs torch.Generator); both
    # include the edges
    hr = R.sample_histogram(jnp.asarray(v), 16, 512, jax.random.PRNGKey(0))
    assert float(hr.boundaries[0]) == float(h.boundaries[0])
