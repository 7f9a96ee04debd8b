"""The sparse expert block as Jamba publishes it (``JambaSparseMoeBlock``
in ``modeling_jamba.py``), float32: a router without bias, a softmax over
the ``num_experts`` logits, the top ``num_experts_per_tok`` of it, and
each of those experts' SwiGLU output (``down(silu(gate(x)) · up(x))``, no
bias) weighted by its probability as it is, the gates not renormalised.
Each expert runs on the tokens routed to it alone, and none is dropped.

Leaves: ``w_router`` ``(d, E)``, ``w_gate``/``w_up`` ``(E, d, f)``,
``w_down`` ``(E, f, d)``.
"""
import torch
import torch.nn.functional as F

matrices = ("w_gate", "w_up", "w_down")


def params(c):
    d, f, E, s = int(c["hidden_size"]), int(c["intermediate_size"]), int(c["num_experts"]), float(c["initializer_range"])
    return {"w_router": ((d, E), s), "w_gate": ((E, d, f), s), "w_up": ((E, d, f), s), "w_down": ((E, f, d), s)}


def apply(c, p, x, w):
    xf = x.reshape(-1, x.shape[-1])
    probs = (xf @ p["w_router"]).softmax(-1)
    gate, idx = probs.topk(int(c["num_experts_per_tok"]), dim=-1)
    wg, wu, wd = w("w_gate", p["w_gate"]), w("w_up", p["w_up"]), w("w_down", p["w_down"])
    y = torch.zeros_like(xf)
    for e in range(probs.shape[-1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        xe = xf[tok]
        y.index_add_(0, tok, gate[tok, slot, None] * ((F.silu(xe @ wg[e]) * (xe @ wu[e])) @ wd[e]))
    return y.reshape(x.shape)
