"""AI21-Jamba2-Mini through the port's ``Engine``: ``systems/engine.py``'s
adapter, with the port options (``repro_torch.configs.options``) that the
published model needs and that adapter does not set:

- no positions: its attention layers carry no RoPE, and nothing is added
  to the stream (the configuration has no ``rope_theta``);
- an RMSNorm on Δ, B and C inside every Mamba mixer;
- top-2 gates used as the softmax gives them, not renormalised;
- the dropless dispatch: every routed token-slot computed once, grouped
  by expert on the device, none dropped and no expert holding every
  token (the capacity dispatch at E/k would need over 100 GB at 104 rows);
- the prefill scan's chunk, ``mamba_chunk`` from the configuration, which
  bounds its float32 ``(rows, chunk, d_inner, d_state)`` tensors.

A configuration the port cannot express (another Δ rank, no convolution
bias, projection biases, a RoPE theta) is refused here.
"""
import dataclasses

from hbench.systems import engine
from repro_torch.configs.options import with_options
from repro_torch.serve import Engine, ServeConfig

KIND = "model"


def port_config(cfg: dict):
    if int(cfg["mamba_dt_rank"]) != int(cfg["hidden_size"]) // 16:
        raise ValueError(f"mamba_dt_rank {cfg['mamba_dt_rank']}: the port's Δ rank is hidden_size // 16")
    if not cfg["mamba_conv_bias"] or cfg["mamba_proj_bias"]:
        raise ValueError("the port's Mamba mixer has a convolution bias and no projection biases")
    if cfg.get("rope_theta") is not None:
        raise ValueError("Jamba's attention carries no positions; this configuration gives a rope_theta")
    return with_options(engine.port_config(cfg), use_rope=False, positions="none", mamba_dbc_norm=True,
                        moe_renormalize=False, moe_dispatch="dropless", mamba_chunk=int(cfg["mamba_chunk"]))


class System(engine.System):
    def __init__(self, cfg: dict, traffic: dict, params: dict, device):
        prompt, new = int(traffic["prompt_tokens"]), int(traffic["new_tokens"])
        scfg = ServeConfig(max_seq=prompt + new, max_new_tokens=new, temperature=0.0,
                           eos_id=int(cfg["vocab_size"]), cache_dtype=cfg["torch_dtype"])
        self.engine = Engine(port_config(cfg), params, scfg, device=device)
