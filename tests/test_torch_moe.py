"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` — the port's mirror of the MoE cases of
``tests/test_models.py``, with the routing decisions held equal.

Both packages run the reference's ``init_moe`` parameters (carried across
bit for bit) on the same seeded NumPy activations, on the CPU, in
float32.  The routing of each call is read where it is made: the
reference's ``jax.lax.top_k`` output and dispatch einsum, the port's
stable ``argsort`` and dispatch einsum, recorded while the call runs.

Tolerance: the top-k expert indices, the dispatch tensor (which token
goes to which expert's which capacity slot) and the port's ``routing``
aux equal, the drop fraction equal; y, the load-balance and router-z losses and the combine weights
within ``atol=5e-5, rtol=1e-5`` (float32; XLA and torch order their
reductions differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.moe as RMoE
import repro_torch.configs as PC
import repro_torch.models.moe as PMoE
from repro.models.common import Init as RInit
from repro_torch.convert import params_from_reference
from repro_torch.models.common import Init

ATOL, RTOL = 5e-5, 1e-5


def both_configs(arch: str, **changes):
    rc = dataclasses.replace(RC.smoke(RC.get_config(arch)), **changes)
    pc = dataclasses.replace(PC.smoke(PC.get_config(arch)), **changes)
    return rc, pc


def moe_params(rc, seed: int = 0):
    rp, _ = RMoE.init_moe(rc, RInit(jax.random.PRNGKey(seed)))
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")


class Recorder:
    """Records the routing of one ``apply_moe`` call in each package:
    the top-k indices and the ``(B, nG, g, E, C)`` combine tensor."""

    def __init__(self, monkeypatch):
        self.seen = {}
        real_top_k, real_jeinsum = jax.lax.top_k, jnp.einsum
        real_argsort, real_teinsum = torch.argsort, torch.einsum

        def top_k(x, k):
            out = real_top_k(x, k)
            self.seen["ref_idx"] = np.asarray(out[1])
            return out

        def jeinsum(spec, *ops, **kw):
            out = real_jeinsum(spec, *ops, **kw)
            if spec == "bngke,bngkc->bngec":
                self.seen["ref_combine"] = np.asarray(out)
            return out

        def argsort(x, *a, **kw):
            out = real_argsort(x, *a, **kw)
            self.seen["port_order"] = out.numpy()
            return out

        def teinsum(spec, *ops):
            out = real_teinsum(spec, *ops)
            if spec == "bngke,bngkc->bngec":
                self.seen["port_combine"] = out.detach().numpy()
            return out

        monkeypatch.setattr(jax.lax, "top_k", top_k)
        monkeypatch.setattr(jnp, "einsum", jeinsum)
        monkeypatch.setattr(torch, "argsort", argsort)
        monkeypatch.setattr(torch, "einsum", teinsum)


def run_both(rc, pc, rp, pp, x: np.ndarray, monkeypatch):
    rec = Recorder(monkeypatch)
    ry, raux = RMoE.apply_moe(rc, rp, jnp.asarray(x))
    with torch.no_grad():
        py, paux = PMoE.apply_moe(pc, pp, torch.from_numpy(x))
    monkeypatch.undo()
    k = pc.num_experts_per_token
    seen = rec.seen
    port_idx = seen["port_order"][..., :k]
    assert port_idx.shape == seen["ref_idx"].shape
    assert np.array_equal(port_idx, seen["ref_idx"])  # the experts, in slot order
    assert np.array_equal(seen["port_combine"] > 0, seen["ref_combine"] > 0)  # token → (expert, slot)
    # aux["routing"]: each token's experts in slot order, -1 where its queue dropped it
    idx = seen["ref_idx"]
    kept = np.take_along_axis(seen["ref_combine"].max(-1), idx, axis=-1) > 0
    want = np.where(kept, idx, -1)
    B0, S0 = x.shape[:2]
    if S0 == 1 and B0 > 1:
        want = want.reshape(B0, S0, k)
    else:
        want = want.reshape(B0, -1, k)[:, :S0]
    assert np.array_equal(paux["routing"].numpy(), want)
    np.testing.assert_allclose(seen["port_combine"], seen["ref_combine"], atol=ATOL, rtol=RTOL)
    assert py.shape == x.shape and py.dtype == torch.float32
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), atol=ATOL, rtol=RTOL)
    for key in ("moe_load_balance", "moe_router_z"):
        np.testing.assert_allclose(float(paux[key]), float(raux[key]), atol=ATOL, rtol=RTOL, err_msg=key)
    assert float(paux["moe_drop_fraction"]) == float(raux["moe_drop_fraction"])
    return py, paux, port_idx


ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 32), (8, 1), (2, 20)], ids=["groups", "decode_fold", "padded_group"])
def test_apply_moe_matches_the_reference(arch, B, S, monkeypatch):
    """Whole groups of 16; the decode fold (B = 8, S = 1: the batch becomes
    one group of 8); a padded last group (S = 20: a group of 16 and one of
    4 real tokens and 12 pads)."""
    rc, pc = both_configs(arch)
    rp, pp = moe_params(rc)
    x = np.random.default_rng(1).normal(size=(B, S, rc.d_model)).astype(np.float32)
    y, aux, idx = run_both(rc, pc, rp, pp, x, monkeypatch)
    if S == 1:  # folded: one group of the whole batch
        assert idx.shape[:3] == (1, 1, B)
    if S == 20:
        assert idx.shape[:3] == (B, 2, 16)
    assert aux["slots"] == idx.shape[0] * idx.shape[1] * idx.shape[2]


def test_moe_dropless_at_high_capacity(monkeypatch):
    rc, pc = both_configs("dbrx-132b", moe_capacity_factor=8.0)
    rp, pp = moe_params(rc)
    x = np.random.default_rng(1).normal(size=(2, 32, rc.d_model)).astype(np.float32)
    _, aux, _ = run_both(rc, pc, rp, pp, x, monkeypatch)
    assert float(aux["moe_drop_fraction"]) == 0.0


def test_moe_default_capacity_drops_like_the_reference(monkeypatch):
    """A router skewed to expert 0 overflows its queue at the default
    capacity (C = 16·2·1.25/4 = 10 a group): the same tokens are dropped."""
    rc, pc = both_configs("dbrx-132b")
    rp, _ = moe_params(rc)
    rp = dict(rp, w_router=rp["w_router"].at[:, 0].add(0.5))
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.abs(np.random.default_rng(2).normal(size=(2, 32, rc.d_model))).astype(np.float32)
    _, aux, _ = run_both(rc, pc, rp, pp, x, monkeypatch)
    assert float(aux["moe_drop_fraction"]) > 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_keep_the_lower_expert_index(arch, monkeypatch):
    """Experts 0 and 1 share a router column, and so do 2 and 3: every
    token's probabilities tie in pairs, and top-k must put the lower index
    first (``jax.lax.top_k``'s order), at the k boundary (k = 1) and in the
    slot order (k = 2)."""
    rc, pc = both_configs(arch)
    rp, _ = moe_params(rc)
    w = np.asarray(rp["w_router"]).copy()
    w[:, 1], w[:, 3] = w[:, 0], w[:, 2]
    rp = dict(rp, w_router=jnp.asarray(w))
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.random.default_rng(3).normal(size=(2, 16, rc.d_model)).astype(np.float32)
    _, _, idx = run_both(rc, pc, rp, pp, x, monkeypatch)
    assert np.all(idx[..., 0] % 2 == 0)  # a tie's lower index wins the first slot
    if idx.shape[-1] == 2:
        assert np.all(idx[..., 1] == idx[..., 0] + 1)


def test_apply_moe_gradients_match_the_reference():
    rc, pc = both_configs("dbrx-132b")
    rp, pp = moe_params(rc)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, rc.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)  # a fixed random readout of y

    def ref_loss(p, x):
        y, aux = RMoE.apply_moe(rc, p, x)
        return jnp.mean(y * r) + aux["moe_load_balance"] + aux["moe_router_z"]

    want = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    pp = {k: v.clone().requires_grad_() for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = PMoE.apply_moe(pc, pp, xt)
    (torch.mean(y * torch.from_numpy(r)) + aux["moe_load_balance"] + aux["moe_router_z"]).backward()
    for key in sorted(pp):
        np.testing.assert_allclose(pp[key].grad.numpy(), np.asarray(want[0][key]), atol=ATOL, rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[1]), atol=ATOL, rtol=RTOL)


def test_init_moe_copies_the_reference_scales():
    """``w_gate``/``w_up`` take fan-in E (N(0, 1/E)), ``w_down`` fan-in
    d_ff, the router fan-in d: the reference's scales, copied on purpose
    (ROADMAP Queue 3)."""
    cfg = dataclasses.replace(PC.smoke(PC.get_config("dbrx-132b")), num_experts=16, d_ff=512)
    p = PMoE.init_moe(cfg, Init(torch.Generator().manual_seed(0), torch.device("cpu")))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_router": (128, 16), "w_gate": (16, 128, 512), "w_up": (16, 128, 512), "w_down": (16, 512, 128)}
    assert float(p["w_gate"].std()) == pytest.approx(16**-0.5, rel=0.02)
    assert float(p["w_up"].std()) == pytest.approx(16**-0.5, rel=0.02)
    assert float(p["w_down"].std()) == pytest.approx(512**-0.5, rel=0.02)
    assert float(p["w_router"].std()) == pytest.approx(128**-0.5, rel=0.05)
