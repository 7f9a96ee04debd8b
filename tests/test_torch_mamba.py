"""The port's Mamba mixer (``repro_torch.models.mamba``) against the
reference's ``repro.models.mamba``, on jamba-v0.1-52b's smoke config
(d 128, d_inner 256, d_state 8, conv 4, chunk 8).

Both packages run the reference's ``init_mamba`` parameters (carried
across bit for bit) on the same seeded NumPy inputs, on the CPU.

Tolerances:
- float32: ``atol=5e-5, rtol=1e-5`` (XLA and torch order their
  reductions differently, and XLA's compiled scan fuses ``a·b + c`` into
  one rounding);
- the associative scan in bfloat16: bit-equal to the reference's compiled
  ``jax.lax.associative_scan`` (the same combines in the same order, each
  rounded to bfloat16);
- bfloat16 compute with the bfloat16 scan: y within 1.5e-2 of its rms in
  rms and 0.1 of its rms at most, the float32 final state within 2e-2 of
  its largest magnitude.  The matmuls and the convolution are bit-equal
  (checked below), but XLA and torch round ``silu``'s bfloat16 result
  differently in a few elements (one bfloat16 ulp, 2^-8 relative), and
  those steps carry through the scan; measured: y 0.0074 rms, 0.070 max,
  the state 0.0053 of its largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.mamba as RMa
import repro_torch.configs as PC
import repro_torch.models.mamba as PMa
from repro.models.common import Init as RInit
from repro_torch.convert import params_from_reference
from repro_torch.models.common import Init

ATOL, RTOL = 5e-5, 1e-5


def both_configs(**changes):
    rc = dataclasses.replace(RC.smoke(RC.get_config("jamba-v0.1-52b")), **changes)
    pc = dataclasses.replace(PC.smoke(PC.get_config("jamba-v0.1-52b")), **changes)
    return rc, pc


def mamba_params(rc, seed: int = 0):
    rp, _ = RMa.init_mamba(rc, RInit(jax.random.PRNGKey(seed)))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")


def close(a, b) -> None:
    np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b).astype(np.float32), atol=ATOL, rtol=RTOL)


def _combine(left, right):
    return left[0] * right[0], right[0] * left[1] + right[1]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 17, 256])
def test_associative_scan_follows_the_reference_recursion(n):
    rng = np.random.default_rng(n)
    # products stay normal: XLA's CPU flushes subnormal results to zero, torch keeps them
    a = rng.uniform(0.9, 1.0, size=(2, n, 6, 4)).astype(np.float32)
    b = rng.normal(size=(2, n, 6, 4)).astype(np.float32)
    scan = jax.jit(lambda x, y: jax.lax.associative_scan(_combine, (x, y), axis=1))
    want = scan(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16))
    got = PMa.associative_scan((torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
    want = scan(jnp.asarray(a), jnp.asarray(b))
    got = PMa.associative_scan((torch.from_numpy(a), torch.from_numpy(b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [17, 8, 3], ids=["two_chunks_and_a_tail", "one_chunk", "short"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_apply_mamba_matches_the_reference(S, with_h0):
    rc, pc = both_configs()
    rp, pp = mamba_params(rc)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, rc.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, 2 * rc.d_model, rc.mamba_d_state)).astype(np.float32) if with_h0 else None
    ry, rh = RMa.apply_mamba(rc, rp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    with torch.no_grad():
        py, ph = PMa.apply_mamba(pc, pp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    assert py.shape == x.shape and ph.shape == (2, 2 * rc.d_model, rc.mamba_d_state) and ph.dtype == torch.float32
    close(py, ry)
    close(ph, rh)


def test_causal_conv_matches_the_reference():
    rc, _ = both_configs()
    rp, pp = mamba_params(rc)
    x = np.random.default_rng(5).normal(size=(2, 11, 2 * rc.d_model)).astype(np.float32)
    want = RMa._causal_depthwise_conv(jnp.asarray(x), rp["conv_w"], rp["conv_b"] + 0.5)
    got = PMa._causal_depthwise_conv(torch.from_numpy(x), pp["conv_w"], pp["conv_b"] + 0.5)
    close(got, want)
    bf = [jnp.asarray(x).astype(jnp.bfloat16), rp["conv_w"].astype(jnp.bfloat16), rp["conv_b"].astype(jnp.bfloat16)]
    want = RMa._causal_depthwise_conv(*bf)
    got = PMa._causal_depthwise_conv(torch.from_numpy(x).bfloat16(), pp["conv_w"].bfloat16(), pp["conv_b"].bfloat16())
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # causal: position t reads inputs 0..t only
    cut = PMa._causal_depthwise_conv(torch.from_numpy(x[:, :6]), pp["conv_w"], pp["conv_b"])
    full = PMa._causal_depthwise_conv(torch.from_numpy(x), pp["conv_w"], pp["conv_b"])
    assert torch.equal(cut, full[:, :6])


def test_decode_mamba_step_matches_the_reference():
    rc, pc = both_configs()
    rp, pp = mamba_params(rc)
    rng = np.random.default_rng(6)
    d_in = 2 * rc.d_model
    x = rng.normal(size=(3, 1, rc.d_model)).astype(np.float32)
    cache = {"h": rng.normal(size=(3, d_in, rc.mamba_d_state)).astype(np.float32),
             "conv": rng.normal(size=(3, rc.mamba_d_conv - 1, d_in)).astype(np.float32)}
    ry, rcache = RMa.decode_mamba_step(rc, rp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()})
    py, pcache = PMa.decode_mamba_step(pc, pp, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in cache.items()})
    close(py, ry)
    assert sorted(pcache) == sorted(rcache)
    for k in rcache:
        close(pcache[k], rcache[k])
    # the new window drops the oldest row and appends this token's pre-conv row
    assert torch.equal(pcache["conv"][:, :-1], torch.from_numpy(cache["conv"][:, 1:]))
    assert torch.equal(pcache["conv"][:, -1], (torch.from_numpy(x) @ pp["wx"])[:, 0])
    empty = PMa.init_mamba_cache(pc, 3, torch.bfloat16, device="cpu")
    assert empty["h"].dtype == torch.float32 and empty["conv"].dtype == torch.bfloat16
    assert tuple(empty["conv"].shape) == (3, rc.mamba_d_conv - 1, d_in)


def test_bf16_compute_and_scan_within_the_stated_tolerance():
    rc, pc = both_configs(mamba_scan_dtype="bfloat16")
    rp, pp = mamba_params(rc)
    x = np.random.default_rng(7).normal(size=(2, 17, rc.d_model)).astype(np.float32)
    ry, rh = jax.jit(lambda p, x: RMa.apply_mamba(rc, p, x))(rp, jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        py, ph = PMa.apply_mamba(pc, pp, torch.from_numpy(x).bfloat16())
    assert py.dtype == torch.bfloat16 and ph.dtype == torch.float32
    ry = np.asarray(ry.astype(jnp.float32))
    diff, scale = py.float().numpy() - ry, np.sqrt(np.mean(ry**2))
    assert np.sqrt(np.mean(diff**2)) <= 1.5e-2 * scale, np.sqrt(np.mean(diff**2)) / scale
    assert np.abs(diff).max() <= 0.1 * scale, np.abs(diff).max() / scale
    rh = np.asarray(rh)
    assert np.abs(ph.numpy() - rh).max() <= 2e-2 * np.abs(rh).max()
    # the projection before the scan is bit-equal: the gap is the elementwise chain's
    wx = (torch.from_numpy(x).bfloat16() @ pp["wx"].bfloat16()).float().numpy()
    assert np.array_equal(wx, np.asarray(jnp.einsum("bsd,di->bsi", jnp.asarray(x).astype(jnp.bfloat16),
                                                    rp["wx"].astype(jnp.bfloat16)).astype(jnp.float32)))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_apply_mamba_gradients_match_the_reference(remat):
    """Gradients through two chunks and a tail; under ``"full"`` each
    chunk is recomputed in the backward, bit-equal to ``"none"``."""
    rc, pc = both_configs(remat_policy=remat)
    rp, pp = mamba_params(rc)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 17, rc.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)

    def ref_loss(p, x):
        y, h = RMa.apply_mamba(rc, p, x)
        return jnp.mean(y * r) + jnp.mean(h)

    want = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))

    def port_grads(cfg):
        ps = {k: v.clone().requires_grad_() for k, v in pp.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y, h = PMa.apply_mamba(cfg, ps, xt)
        (torch.mean(y * torch.from_numpy(r)) + torch.mean(h)).backward()
        return {k: v.grad for k, v in ps.items()}, xt.grad

    got, gx = port_grads(pc)
    for key in sorted(pp):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[0][key]), atol=ATOL, rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want[1]), atol=ATOL, rtol=RTOL)
    if remat == "full":
        plain, px = port_grads(dataclasses.replace(pc, remat_policy="none"))
        assert all(torch.equal(got[k], plain[k]) for k in plain) and torch.equal(gx, px)


def test_init_mamba_shapes_and_constants():
    _, pc = both_configs()
    gen = torch.Generator().manual_seed(0)
    p = PMa.init_mamba(pc, Init(gen, torch.device("cpu")))
    d, d_in, n, K, r = 128, 256, pc.mamba_d_state, pc.mamba_d_conv, 8
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wx": (d, d_in), "wz": (d, d_in), "conv_w": (d_in, K), "conv_b": (d_in,), "w_dbc": (d_in, r + 2 * n),
        "w_dt": (r, d_in), "dt_bias": (d_in,), "A_log": (d_in, n), "D": (d_in,), "w_out": (d_in, d)}
    rp, _ = RMa.init_mamba(RC.smoke(RC.get_config("jamba-v0.1-52b")), RInit(jax.random.PRNGKey(0)))
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(rp["A_log"]), rtol=1e-7)
    assert p["A_log"].is_contiguous()
    assert torch.equal(p["D"], torch.ones(d_in)) and not bool(p["conv_b"].any())
    assert float(p["dt_bias"].std()) == pytest.approx(0.1, rel=0.2)
    assert float(p["conv_w"].std()) == pytest.approx(K**-0.5, rel=0.1)
    # Init.const draws nothing: the draw after A_log's is D's neighbour w_out's
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    Init(g1, torch.device("cpu")).const(lambda: torch.zeros(2, 3), (2, 3))
    assert torch.equal(torch.randn(4, generator=g1), torch.randn(4, generator=g2))
