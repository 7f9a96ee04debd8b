"""Faults planted in the program underneath a run: each turns a sound run
into one that ``correct`` must call wrong.  ``FAULTS[name](mp)`` plants one
through ``mp``, a ``pytest.MonkeyPatch`` (``test_hbench_faults.py`` runs
them at tiny sizes; ``control.py --fault`` at a cell's own size).

The store's: its state left unchanged, half a day's values dropped, half a
batch of queries answered, an answer or a summary moved one ulp.  The
served model's: a decode step that writes its key and value one slot off,
one that never writes them (its state left unchanged), qk-norm left out of
decode, a served token altered, half of a turn's rows left out.  The
exchange between chips is not among them: every cell runs on one card.

A configuration may bring faults of its own, as a file: ``planted/<config>.py``
with ``FAULTS`` (name -> plant, as here) and ``CASES`` (``(workload,
fault)`` pairs that ``test_hbench_faults.py`` runs).  :func:`planted` finds
them beside these.
"""
import dataclasses
import os

import torch

from hbench import harness
from repro_torch.core import interval_tree, stream
from repro_torch.core.stream import HistogramStore
from repro_torch.models import attention
from repro_torch.serve import Engine


def half_answered(real):
    """Answers the first half of a batch (rounded down); the rest get the
    first half's answers, and a batch of one gets none."""
    def query_many(self, queries, beta, **kw):
        keep = len(queries) // 2
        out = real(self, queries[:keep], beta, **kw) if keep else []
        return [out[i % keep] for i in range(len(queries))] if keep else []
    return query_many


def nudged(real):
    """The merge, with one boundary of every answer moved one ulp."""
    def merge_stacks(bounds, sizes, beta, device=None):
        bo, so = real(bounds, sizes, beta, device=device)
        bo = bo.clone()
        mid = bo.shape[-1] // 2
        bo[:, mid] = bo[:, mid].nextafter(bo[:, mid] + 1)
        return bo, so
    return merge_stacks


def nudged_summaries(real):
    def build(values, ns, num_buckets, *a, **k):
        h = real(values, ns, num_buckets, *a, **k)
        b = h.boundaries.clone()
        b[:, 1] = b[:, 1].nextafter(b[:, 1] + 1)
        return type(h)(b, h.sizes)
    return build


def _decode_writing_at(offset):
    """``attention.decode_attention_step`` with the new key and value
    written ``offset`` slots past the token's position (clamped into the
    cache), or, with ``offset`` ``None``, not written at all.  The slot is
    worked out on the device from ``position`` (a 0-d int32 tensor there),
    as the program's step does, so a CUDA graph captures the step."""
    def step(cfg, p, x, position, cache, *, kind="global"):
        B = x.shape[0]
        Hkv, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        q, k, v = attention._project_qkv(cfg, p, x, position, cfg.use_rope)
        if offset is not None:
            slot = (position + offset).clamp(0, cache["k"].shape[1] - 1).long()
            cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        out = attention.decode_attention(q.reshape(B, 1, Hkv, G, cfg.head_dim), cache["k"], cache["v"], position,
                                         window=attention._window(cfg, kind), logit_cap=cfg.attn_softcap)
        return attention._out(out.reshape(B, 1, cfg.num_heads, cfg.head_dim), p["wo"]), cache
    return step


def qk_norm_skipped(real):
    return lambda cfg, *a, **k: real(dataclasses.replace(cfg, qk_norm=False), *a, **k)


def half_the_rows_answered(real):
    """Generates for the first half of a turn's prompts; the other rows
    get the first half's answers."""
    def generate(self, prompts, generator=None):
        out = real(self, prompts[: len(prompts) // 2], generator)
        return [out[i % len(out)] for i in range(len(prompts))]
    return generate


FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(HistogramStore, "_apply", lambda self, summs: None),
    "half_the_day_left_out": lambda mp: mp.setattr(
        HistogramStore, "ingest", (lambda real: lambda self, pid, v: real(self, pid, v[: len(v) // 2]))(HistogramStore.ingest)),
    "half_the_batch_left_out": lambda mp: mp.setattr(HistogramStore, "query_many", half_answered(HistogramStore.query_many)),
    "answer_altered": lambda mp: mp.setattr(interval_tree, "merge_stacks", nudged(interval_tree.merge_stacks)),
    "summary_altered": lambda mp: mp.setattr(stream, "build_exact_padded_batched",
                                             nudged_summaries(stream.build_exact_padded_batched)),
    "kv_one_position_off": lambda mp: mp.setattr(attention, "decode_attention_step", _decode_writing_at(1)),
    "kv_cache_unwritten": lambda mp: mp.setattr(attention, "decode_attention_step", _decode_writing_at(None)),
    "qk_norm_skipped_in_decode": lambda mp: mp.setattr(attention, "decode_attention_step",
                                                       qk_norm_skipped(attention.decode_attention_step)),
    "token_altered": lambda mp: mp.setattr(Engine, "_sample", (lambda real: lambda self, logits, g: (
        real(self, logits, g) + 1) % logits.shape[-1])(Engine._sample)),
    "half_the_rows_left_out": lambda mp: mp.setattr(Engine, "generate", half_the_rows_answered(Engine.generate)),
}


def planted(root: str = harness.ROOT) -> tuple[dict, list]:
    """Every fault in the checkout ``root``, these and each
    ``planted/<config>.py``'s, and the cases the planted files name."""
    faults, cases = dict(FAULTS), []
    folder = os.path.join(root, "hbench", "planted")
    for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else []:
        if not name.endswith(".py"):
            continue
        mod = harness.load_module(os.path.join(folder, name))
        clash = sorted(faults.keys() & mod.FAULTS.keys())
        if clash:
            raise ValueError(f"planted/{name} names faults that are already planted: {clash}")
        faults.update(mod.FAULTS)
        cases += [tuple(c) for c in mod.CASES]
    return faults, cases
