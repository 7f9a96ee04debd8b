"""The port's RWKV-6 block (``repro_torch.models.rwkv``) against the
reference's ``repro.models.rwkv``, on rwkv6-7b's smoke config (d 128, 4
heads × 32, d_ff 512, decay LoRA 8, chunk 8).

Both packages run the reference's ``init_rwkv_time_mix`` /
``init_rwkv_channel_mix`` parameters (carried across bit for bit) on the
same seeded NumPy inputs, on the CPU, in float32.

Tolerance: ``atol=5e-5, rtol=1e-5`` (XLA and torch order their
reductions and matmul accumulations differently; XLA's compiled scan may
fuse ``w · S + kv`` into one rounding).  The remat policies are
bit-equal to each other (the same ops, recomputed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.rwkv as RR
import repro_torch.configs as PC
import repro_torch.models.rwkv as PR
from repro.models.common import Init as RInit
from repro_torch.convert import params_from_reference
from repro_torch.models.common import Init

ATOL, RTOL = 5e-5, 1e-5
CPU = torch.device("cpu")


def both_configs(**changes):
    rc = dataclasses.replace(RC.smoke(RC.get_config("rwkv6-7b")), **changes)
    pc = dataclasses.replace(PC.smoke(PC.get_config("rwkv6-7b")), **changes)
    return rc, pc


def params(rc, which: str, seed: int = 0):
    init = RR.init_rwkv_time_mix if which == "tm" else RR.init_rwkv_channel_mix
    rp, _ = init(rc, RInit(jax.random.PRNGKey(seed)))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)


def close(a, b) -> None:
    np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b).astype(np.float32), atol=ATOL, rtol=RTOL)


def carries(rc, B: int, rng, carried: bool):
    """A carried state ``(B, H, hd, hd)`` and last token ``(B, 1, d)``, or
    ``None``s."""
    if not carried:
        return None, None
    hd = rc.d_model // rc.rwkv_heads
    return (rng.normal(size=(B, rc.rwkv_heads, hd, hd)).astype(np.float32),
            rng.normal(size=(B, 1, rc.d_model)).astype(np.float32))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("S", [17, 8, 3], ids=["two_chunks_and_a_tail", "one_chunk", "short"])
@pytest.mark.parametrize("carried", [False, True], ids=["from_zeros", "carried"])
def test_time_mix_matches_the_reference(S, carried):
    rc, pc = both_configs()
    rp, pp = params(rc, "tm")
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, rc.d_model)).astype(np.float32)
    state, x_carry = carries(rc, 2, rng, carried)
    ry, (rS, rlast) = RR.apply_rwkv_time_mix(rc, rp, jnp.asarray(x), _j(state), _j(x_carry))
    with torch.no_grad():
        py, (pS, plast) = PR.apply_rwkv_time_mix(pc, pp, torch.from_numpy(x), _t(state), _t(x_carry))
    assert py.shape == x.shape and pS.dtype == torch.float32 and pS.shape == rS.shape
    close(py, ry)
    close(pS, rS)
    assert torch.equal(plast, torch.from_numpy(x[:, -1:])) and np.array_equal(np.asarray(rlast), x[:, -1:])


@pytest.mark.parametrize("S", [17, 8, 3], ids=["two_chunks_and_a_tail", "one_chunk", "short"])
@pytest.mark.parametrize("carried", [False, True], ids=["from_zeros", "carried"])
def test_channel_mix_matches_the_reference(S, carried):
    rc, pc = both_configs()
    rp, pp = params(rc, "cm")
    rng = np.random.default_rng(S + 10)
    x = rng.normal(size=(2, S, rc.d_model)).astype(np.float32)
    _, x_carry = carries(rc, 2, rng, carried)
    ry, rlast = RR.apply_rwkv_channel_mix(rc, rp, jnp.asarray(x), _j(x_carry))
    with torch.no_grad():
        py, plast = PR.apply_rwkv_channel_mix(pc, pp, torch.from_numpy(x), _t(x_carry))
    close(py, ry)
    assert torch.equal(plast, torch.from_numpy(x[:, -1:]))


def test_token_shift_and_mix():
    rc, _ = both_configs()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    prev = rng.normal(size=(2, 1, 16)).astype(np.float32)
    mu = rng.normal(size=(16,)).astype(np.float32)
    for p in (None, prev):
        got = PR._shift(torch.from_numpy(x), _t(p))
        assert torch.equal(got, torch.from_numpy(np.array(RR._shift(jnp.asarray(x), _j(p)))))
    xp = PR._shift(torch.from_numpy(x))
    close(PR._mix(torch.from_numpy(x), xp, torch.from_numpy(mu)),
          RR._mix(jnp.asarray(x), RR._shift(jnp.asarray(x)), jnp.asarray(mu)))
    # bfloat16 activations: sigmoid(μ) in float32, then cast to bfloat16
    xb = torch.from_numpy(x).bfloat16()
    got = PR._mix(xb, PR._shift(xb), torch.from_numpy(mu))
    assert got.dtype == torch.bfloat16
    want = RR._mix(jnp.asarray(x).astype(jnp.bfloat16), RR._shift(jnp.asarray(x).astype(jnp.bfloat16)),
                   jnp.asarray(mu))
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_decay_projection_matches_the_reference():
    rc, pc = both_configs()
    rp, pp = params(rc, "tm")
    x = np.random.default_rng(4).normal(size=(2, 9, rc.d_model)).astype(np.float32)
    want = RR._time_mix_projections(rc, rp, jnp.asarray(x), RR._shift(jnp.asarray(x)))
    got = PR._time_mix_projections(pc, pp, torch.from_numpy(x), PR._shift(torch.from_numpy(x)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)
    w = got[-1]
    assert w.dtype == torch.float32 and bool(((w > 0) & (w < 1)).all())


def test_decode_step_matches_the_reference():
    """One token against a carried state and last tokens, time mix then
    channel mix, as the model's decode runs them."""
    rc, pc = both_configs()
    (rtm, ptm), (rcm, pcm) = params(rc, "tm"), params(rc, "cm", seed=1)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 1, rc.d_model)).astype(np.float32)
    state, x_tm = carries(rc, 3, rng, True)
    x_cm = rng.normal(size=(3, 1, rc.d_model)).astype(np.float32)
    ry, (rS, _) = RR.apply_rwkv_time_mix(rc, rtm, jnp.asarray(x), jnp.asarray(state), jnp.asarray(x_tm))
    rz, _ = RR.apply_rwkv_channel_mix(rc, rcm, ry, jnp.asarray(x_cm))
    with torch.no_grad():
        py, (pS, _) = PR.apply_rwkv_time_mix(pc, ptm, torch.from_numpy(x), torch.from_numpy(state),
                                             torch.from_numpy(x_tm))
        pz, _ = PR.apply_rwkv_channel_mix(pc, pcm, py, torch.from_numpy(x_cm))
    close(py, ry)
    close(pS, rS)
    close(pz, rz)
    # the state update by hand: S' = w·S + k⊗v
    _, k, v, _, w = PR._time_mix_projections(pc, ptm, torch.from_numpy(x), torch.from_numpy(x_tm))
    by_hand = w[:, 0, :, :, None] * torch.from_numpy(state) + k[:, 0, :, :, None] * v[:, 0, :, None, :]
    torch.testing.assert_close(pS, by_hand, atol=0, rtol=0)
    empty = PR.init_rwkv_cache(pc, 3, torch.bfloat16, device=CPU)
    rempty, _ = RR.init_rwkv_cache(rc, 3)
    assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in empty.items()} == {
        k: (a.shape, str(a.dtype)) for k, a in rempty.items()}
    assert empty["S"].dtype == torch.float32 and empty["x_tm"].dtype == torch.bfloat16


@pytest.mark.parametrize("remat", ["none", "full"])
def test_time_mix_gradients_match_the_reference(remat):
    """Gradients through two chunks and a tail, from a carried state; under
    ``"full"`` each chunk is recomputed in the backward, bit-equal to
    ``"none"``."""
    rc, pc = both_configs(remat_policy=remat)
    rp, pp = params(rc, "tm")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 17, rc.d_model)).astype(np.float32)
    state, _ = carries(rc, 2, rng, True)
    r = rng.normal(size=x.shape).astype(np.float32)

    def ref_loss(p, x, s):
        y, (S, _) = RR.apply_rwkv_time_mix(rc, p, x, s)
        return jnp.mean(y * r) + jnp.mean(S)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(rp, jnp.asarray(x), jnp.asarray(state))

    def port_grads(cfg):
        ps = {k: v.clone().requires_grad_() for k, v in pp.items()}
        xt, st = torch.from_numpy(x).requires_grad_(), torch.from_numpy(state).requires_grad_()
        y, (S, _) = PR.apply_rwkv_time_mix(cfg, ps, xt, st)
        (torch.mean(y * torch.from_numpy(r)) + torch.mean(S)).backward()
        return {k: v.grad for k, v in ps.items()}, xt.grad, st.grad

    got, gx, gs = port_grads(pc)
    for key in sorted(pp):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[0][key]), atol=ATOL, rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want[1]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(want[2]), atol=ATOL, rtol=RTOL)
    if remat == "full":
        plain, px, ps_ = port_grads(dataclasses.replace(pc, remat_policy="none"))
        assert all(torch.equal(got[k], plain[k]) for k in plain) and torch.equal(gx, px) and torch.equal(gs, ps_)


def test_channel_mix_gradients_match_the_reference():
    rc, pc = both_configs()
    rp, pp = params(rc, "cm")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 11, rc.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda p: jnp.mean(RR.apply_rwkv_channel_mix(rc, p, jnp.asarray(x))[0] * r))(rp)
    ps = {k: v.clone().requires_grad_() for k, v in pp.items()}
    torch.mean(PR.apply_rwkv_channel_mix(pc, ps, torch.from_numpy(x))[0] * torch.from_numpy(r)).backward()
    for key in sorted(pp):
        np.testing.assert_allclose(ps[key].grad.numpy(), np.asarray(want[key]), atol=ATOL, rtol=RTOL, err_msg=key)


def test_init_shapes_and_scales():
    _, pc = both_configs()
    d, f, H, lora = pc.d_model, pc.d_ff, pc.rwkv_heads, pc.rwkv_decay_lora
    rng = Init(torch.Generator().manual_seed(0), CPU)
    tm, cm = PR.init_rwkv_time_mix(pc, rng), PR.init_rwkv_channel_mix(pc, rng)
    rc, _ = both_configs()
    rtm, _ = RR.init_rwkv_time_mix(rc, RInit(jax.random.PRNGKey(0)))
    rcm, _ = RR.init_rwkv_channel_mix(rc, RInit(jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in tm.items()} == {k: v.shape for k, v in rtm.items()}
    assert {k: tuple(v.shape) for k, v in cm.items()} == {k: v.shape for k, v in rcm.items()}
    assert tm["u"].shape == (H, d // H) and tm["wB"].shape == (lora, d) and cm["wv"].shape == (f, d)
    assert all(v.dtype == torch.float32 for v in (*tm.values(), *cm.values()))
    assert torch.equal(tm["ln_g"], torch.ones(d)) and not bool(tm["ln_b"].any())
    # the reference's scales: mixes 0.2, w0 and u 0.5, dense 1/√fan_in (wB's fan-in the LoRA rank,
    # channel-mix wv's d_ff)
    for key, scale in (("mix_r", 0.2), ("mix_w", 0.2), ("w0", 0.5), ("u", 0.5), ("wA", d**-0.5), ("wB", lora**-0.5),
                       ("wr", d**-0.5), ("wo", d**-0.5)):
        assert float(tm[key].std()) == pytest.approx(scale, rel=0.2), key
    for key, scale in (("mix_k", 0.2), ("wk", d**-0.5), ("wr", d**-0.5), ("wv", f**-0.5)):
        assert float(cm[key].std()) == pytest.approx(scale, rel=0.2), key
