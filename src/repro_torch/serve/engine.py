"""Serving engine: batched prefill + decode with histogram calibration.

Port of the reference's ``repro.serve.engine.Engine``: padded batch →
``prefill`` → token-by-token ``decode_step`` with stop handling.  The
histogram integration is quantization calibration: the activation clip
range comes from merged equi-depth summaries (:meth:`Engine.calibrate`),
giving an int8 scale with a bounded-rank-error quantile instead of an
ad-hoc max.  On the card, the summaries are the row-sort kernel
(``build_exact``) and their merge the merge kernel (``merge_list``).

The engine runs on the card unless ``device="cpu"`` is given; without a
card it raises.  It holds the parameters on its device and, for a
bfloat16 config, one compute-dtype copy of the block weights (the
encoder's too), made once: the bits the reference gets by casting at
every use.  An encoder-decoder config generates from zero ``frames``, as
the reference does.

It also holds the caches of the batch shape it last served, zeroed at the
start of each turn, and a static token and position beside them: the
position is set once after the prefill, and each decode step advances it
on the device.  On the card the first decode step of a shape runs eagerly
(the warm-up), the second is captured into a CUDA graph, and every later
step of that shape replays it: one launch a token in place of the step's
few thousand.  A new shape drops the old caches and graph before it builds
its own.  Sampling stays outside the graph; the one host sync a token is
the sampled ids' copy to the host.

Copied from the reference on purpose (ROADMAP Queue 3): a ragged batch is
right-padded with token 0, every row samples its first new token at
position L−1 and decodes from position L, so a short prompt continues
after its padding and its answer depends on what it was batched with.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spans
from repro_torch.core.histogram import Histogram, build_exact, merge_list, quantile
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels import _lib
from repro_torch.kernels.gqa_decode import visible
from repro_torch.models.model import _compute_dtype, _mixer, decode_step, forward_hidden, init_cache, prefill
from repro_torch.tree import leaves, tree_map

__all__ = ["Engine", "ServeConfig"]

# the block leaves the reference casts to the compute dtype at each use
# (the experts', the cross-attention's and the RWKV projections' too); the
# router, A_log, D, dt_bias, Mamba's Δ/B/C norms and RWKV's wA, wB, w0, u,
# mix_* it uses in float32
_CAST = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "b_up", "b_down",
         "wx", "wz", "conv_w", "conv_b", "w_dbc", "w_dt", "w_out", "wr", "wg"}


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 256
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = 1
    cache_dtype: str = "float32"


def _counters() -> dict[str, int]:
    """The program counters (``core.spans``) as they stand."""
    snap = spans.snapshot()
    return {name: snap[name] for name in spans.COUNTERS}


def _compute_copy(node, dtype: torch.dtype, key: str = ""):
    """The blocks' matmul weights in ``dtype`` (once), the rest as given."""
    if isinstance(node, dict):
        return {k: _compute_copy(v, dtype, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_compute_copy(c, dtype) for c in node]
    return node.to(dtype) if key in _CAST else node


class Engine:
    """Greedy or sampled generation and int8 calibration for one model.

    ``params``: the parameter tree (``models.init_model``,
    ``convert.params_from_reference``) or a ``models.Model``."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *, device=None):
        if isinstance(params, torch.nn.Module):
            params = params.params()
        self.cfg, self.scfg = cfg, scfg
        self.device = resolve_device(device)
        with torch.no_grad():
            self.params = tree_map(lambda t: as_tensor(t, self.device).detach(), params)
            self._run = dict(self.params)
            for key in ("blocks", "encoder"):  # the norms in them stay float32
                if key in self.params:
                    self._run[key] = _compute_copy(self.params[key], _compute_dtype(cfg))
        # the decode state of the shape last served (``_hold``)
        self._shape = self._cache = self._tok = self._pos = None
        self._graph = self._logits = None
        self._launches: dict[str, int] = {}  # kernel wrapper calls a replay stands for
        self._counted: dict[str, int] = {}  # program counters (core.spans) a replay stands for
        self._warm = False  # a step of this shape has run eagerly
        local = any(_mixer(kind) == "local" for kind in cfg.pattern)
        self._window = cfg.sliding_window if local else None  # for the host check of a decode position

    def _pad_batch(self, prompts: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        B = len(prompts)
        L = max(len(p) for p in prompts)
        toks = np.zeros((B, L), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
            lens[i] = len(p)
        return toks, lens

    @torch.no_grad()
    def generate(self, prompts: Sequence[np.ndarray],
                 generator: torch.Generator | None = None) -> list[np.ndarray]:
        """Greedy/sampled continuation for a batch of token-id prompts.
        Sampling (``temperature > 0``) draws from ``generator`` (``None`` →
        a generator on the engine's device seeded with 0)."""
        cfg, scfg = self.cfg, self.scfg
        toks, _ = self._pad_batch(prompts)
        B, L = toks.shape
        cache = self._hold(B)
        batch = {"tokens": as_tensor(toks, self.device)}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=torch.float32, device=self.device)
        logits, _ = prefill(cfg, self._run, batch, cache)
        self._pos.fill_(L)
        if generator is None and scfg.temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = [list(p) for p in prompts]
        tok = self._sample(logits[:, -1], generator)
        done = np.zeros((B,), bool)
        for step in range(scfg.max_new_tokens):
            t = tok.cpu().numpy()
            for i in range(B):
                if not done[i]:
                    out[i].append(int(t[i]))
                    done[i] |= int(t[i]) == scfg.eos_id
            if done.all():
                break
            if self.device.type == "cuda":  # the kernel reads the position on the card: check it here
                visible(L + step, scfg.max_seq, self._window)
            logits = self._decode(tok)
            tok = self._sample(logits[:, -1], generator)
        return [np.asarray(o, np.int32) for o in out]

    def _hold(self, B: int) -> tuple:
        """The caches of a ``B``-row turn, zeroed (one memset a buffer): those
        of the last turn where the shape is the same, else new ones, built
        after the old caches and graph are dropped."""
        dtype = torch.float32 if self.scfg.cache_dtype == "float32" else torch.bfloat16
        shape = (B, self.scfg.max_seq, dtype)
        if shape == self._shape:
            for t in leaves(self._cache):
                t.zero_()
            return self._cache
        self._shape = self._cache = self._tok = self._pos = self._graph = self._logits = None
        self._warm = False
        self._cache = init_cache(self.cfg, B, self.scfg.max_seq, dtype=dtype, device=self.device)
        self._tok = torch.zeros((B, 1), dtype=torch.int32, device=self.device)
        self._pos = torch.zeros((), dtype=torch.int32, device=self.device)
        self._shape = shape
        return self._cache

    def _step(self) -> torch.Tensor:
        """One decode step of the static token at the static position, which
        it then advances on the device → the logits ``(B, 1, V)``."""
        logits, _ = decode_step(self.cfg, self._run, self._cache, self._tok, self._pos)
        self._pos += 1
        return logits

    def _decode(self, tok: torch.Tensor) -> torch.Tensor:
        """The logits after the sampled ids ``tok`` ``(B,)``: on the card a
        replay of the captured step (the shape's first step runs eagerly, its
        second captures), elsewhere the step itself."""
        self._tok.copy_(tok[:, None])
        if self.device.type != "cuda":
            return self._step()
        if self._graph is None:
            if not self._warm:
                self._warm = True
                return self._step()
            self._capture()
        self._graph.replay()
        for name, n in self._launches.items():
            _lib.count(name, n)
        for name, n in self._counted.items():
            spans.count(name, n)
        return self._logits

    def _capture(self) -> None:
        """Capture one :meth:`_step` into a CUDA graph whose pool holds its
        intermediates and its logits; the kernel wrapper calls and program
        counters the capture counted are taken back (it ran nothing) and
        added at each replay."""
        before, counted = dict(_lib.LAUNCHES), _counters()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._logits = self._step()
        except RuntimeError as exc:
            raise RuntimeError(f"{self.cfg.name}: a decode step could not be captured in a CUDA graph; a step "
                               "must read no device value on the host and keep its shapes from step to step") from exc
        self._launches = {name: n - before[name] for name, n in _lib.LAUNCHES.items() if n != before[name]}
        for name, n in self._launches.items():
            _lib.count(name, -n)
        self._counted = {name: n - counted[name] for name, n in _counters().items() if n != counted[name]}
        for name, n in self._counted.items():
            spans.count(name, -n)
        self._graph = graph

    def _sample(self, logits: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # Gumbel-max, as jax.random.categorical draws (other draws, by design)
        u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits.float() / self.scfg.temperature + gumbel, dim=-1).to(torch.int32)

    # ---- histogram-calibrated quantization --------------------------------
    @torch.no_grad()
    def calibration_values(self, batch: dict) -> torch.Tensor:
        """|final hidden| of one calibration batch (``tokens``, and the
        frontend's ``frames`` or ``patch_embeds`` where it has them),
        flat, float32."""
        hidden, _ = forward_hidden(self.cfg, self._run, {k: as_tensor(v, self.device) for k, v in batch.items()})
        return torch.abs(hidden).reshape(-1).float()

    def calibrate(
        self, sample_batches: Sequence[dict], q: float = 0.999, T: int = 512
    ) -> dict[str, float]:
        """Per-run activation clip scale from merged per-batch summaries.

        Runs the forward on each calibration batch, summarizes |final
        hidden| per batch with an exact T-bucket histogram, merges the
        summaries (the paper's Merger — batches are the partitions), and
        returns the q-quantile clip + int8 scale.  Theorem 1 bounds the
        clip's rank error by 2/T of the calibration mass.
        """
        summaries: list[Histogram] = []
        n_total = 0
        for b in sample_batches:
            flat = self.calibration_values(b)
            summaries.append(build_exact(flat, min(T, flat.shape[0])))
            n_total += flat.shape[0]
        merged = merge_list(summaries, min(T, 254))
        clip = float(quantile(merged, np.float32(q)))
        return {
            "clip": clip,
            "int8_scale": clip / 127.0,
            "rank_error_bound": 2.0 * n_total / T,
            "n_calibration_values": n_total,
        }
