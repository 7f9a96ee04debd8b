"""One ``repro_torch`` serving ``Engine``: a decoder served in batches,
greedy, through ``Engine.generate``.

The configuration names the port's architecture (``arch``, a
``repro_torch.configs`` name) and gives its published sizes under Hugging
Face's keys, which replace the port's own.  Where the port has an option
that departs from the published model, the adapter sets it to what the
model publishes, and a configuration has no say: experts drop no token
(each can take every token of a group), and a selective scan runs in
float32.  The weights are the harness's, made from the seed
(``reference/model.py``) in the configuration's ``torch_dtype``, as a
checkpoint is published, in the program's tree layout.  A turn's prompts
all have one length and ask for ``new_tokens`` each; ``eos_id`` lies
outside the vocabulary, so every row generates them all.  The interface
is the one ``systems/__init__.py`` states for a model.
"""
from __future__ import annotations

import dataclasses

from hbench.systems import program_counters
from repro_torch.configs import get_config
from repro_torch.core import spans
from repro_torch.serve import Engine, ServeConfig

KIND = "model"

# Hugging Face's key -> the port's ModelConfig field
_FIELDS = {
    "hidden_size": "d_model", "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size", "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings", "torch_dtype": "compute_dtype",
    "qk_norm": "qk_norm", "num_experts": "num_experts", "num_experts_per_tok": "num_experts_per_token",
    "mamba_d_state": "mamba_d_state", "mamba_d_conv": "mamba_d_conv", "mamba_expand": "mamba_expand",
}


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of ``cfg``: its ``arch`` with the
    published sizes, the depth as whole periods of ``pattern``."""
    mc = get_config(cfg["arch"])
    if tuple(cfg["pattern"]) != mc.pattern:
        raise ValueError(f"{cfg['arch']}'s pattern is {mc.pattern}, the configuration's {cfg['pattern']}")
    fields = {f: cfg[k] for k, f in _FIELDS.items() if k in cfg}
    fields.setdefault("head_dim", int(cfg["hidden_size"]) // int(cfg["num_attention_heads"]))  # no key: d / H
    fields["repeats"] = int(cfg["num_hidden_layers"]) // len(mc.pattern)
    if "num_experts" in cfg:  # capacity for every token in one expert: none dropped
        fields["moe_capacity_factor"] = float(cfg["num_experts"]) / float(cfg["num_experts_per_tok"])
    if any(kind.startswith("mamba") for kind in cfg["pattern"]):
        fields["mamba_scan_dtype"] = "float32"
    return dataclasses.replace(mc, **fields)


class System:
    def __init__(self, cfg: dict, traffic: dict, params: dict, device):
        prompt, new = int(traffic["prompt_tokens"]), int(traffic["new_tokens"])
        scfg = ServeConfig(max_seq=prompt + new, max_new_tokens=new, temperature=0.0,
                           eos_id=int(cfg["vocab_size"]), cache_dtype=cfg["torch_dtype"])
        self.engine = Engine(port_config(cfg), params, scfg, device=device)

    def generate(self, prompts: list) -> list:
        """Each prompt followed by the tokens served after it."""
        return self.engine.generate(prompts)

    def warm(self, prompts: list) -> None:
        """A turn of the window's shapes that stops after two tokens: the
        prefill and the decode step (the same shapes at every position),
        without the rest of a turn's identical steps."""
        scfg = self.engine.scfg
        self.engine.scfg = dataclasses.replace(scfg, max_new_tokens=2)
        try:
            self.engine.generate(prompts)
        finally:
            self.engine.scfg = scfg

    def counters(self) -> dict:
        return program_counters(spans.snapshot())

    def close(self) -> None:
        self.engine = None
