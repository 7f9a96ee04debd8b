"""Each cell cut to a size the CPU tests run in about a second: the same
loops, adapters, reference and checks, on the plain versions of the
program's kernels (``device="cpu"``).  A limit that depends on the size
(a served model's logit gap) is set anew for the tiny size."""
from __future__ import annotations

import copy

CONFIG = {
    "paper_month": {"values_per_partition": 5000, "num_buckets": 64, "pool_partitions": 7},
    # qwen3-8b's smoke widths (repro_torch.configs.smoke), two layers
    "qwen3_8b": {"hidden_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
                 "intermediate_size": 256, "vocab_size": 512, "num_hidden_layers": 2},
}
TRAFFIC = {
    "daily_publish": {"beta": 16},
    "windows_uniform": {"beta": 16, "rate_per_s": 300, "check_answers": 100},
    "offline_batch": {"batch": 8, "prompt_tokens": 24, "new_tokens": 24},
}


# a served model's limit at its tiny size, set as the full cell's was, from
# readings of this size (CPU, 13 seeds): the program's widest gap 0.0212 (up
# to 11 turns judged), the float8 control's narrowest 0.0700 (one turn)
LIMITS = {
    "qwen3_8b.offline": {"token_gap_sd": 0.04},
}


def overrides(cell: dict) -> dict:
    out = {"config": CONFIG[cell["config"]], "traffic": TRAFFIC[cell["traffic"]]}
    if cell["name"] in LIMITS:
        out["limits"] = LIMITS[cell["name"]]
    return copy.deepcopy(out)
