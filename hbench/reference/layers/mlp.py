"""The SwiGLU feed-forward, as Qwen3 publishes it: ``down(silu(gate(x)) ·
up(x))``, no bias, float32.

Leaves: ``w_gate``/``w_up`` ``(d, f)``, ``w_down`` ``(f, d)``.
"""
import torch.nn.functional as F

matrices = ("w_gate", "w_up", "w_down")


def params(c):
    d, f, std = int(c["hidden_size"]), int(c["intermediate_size"]), float(c["initializer_range"])
    return {"w_gate": ((d, f), std), "w_up": ((d, f), std), "w_down": ((f, d), std)}


def apply(c, p, x, w):
    return (F.silu(x @ w("w_gate", p["w_gate"])) * (x @ w("w_up", p["w_up"]))) @ w("w_down", p["w_down"])
