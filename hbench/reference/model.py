"""The plain reference of a served decoder: its parameter tree, made from
the seed, and its forward pass in float32 ``torch``, with no cache, no
batching tricks and no kernel of the program.

A configuration (``configs/<config>.json``) gives the published sizes
under Hugging Face's keys and a ``pattern`` of layer kinds, each
``"<mixer>+<ffn>"`` (``attn+mlp`` for Qwen3).  Each part of a kind is
computed by a file found by name as the harness finds a cell's files:
``layers/<config>/<part>.py`` where the configuration (its ``name``)
brings its own variant of the part, else ``layers/<part>.py``, the
published part that configurations share.  Each has three functions:

- ``params(c)``: ``{leaf: (shape, std)}`` of one layer's part;
- ``apply(c, p, x, w)``: the part on the normed stream ``x`` ``(n, S,
  d)``, float32, with ``w(leaf, p[leaf])`` the weight it multiplies by;
- ``matrices``: the leaves that are matrices (what the control rounds).

The tree is the layout the program takes: ``embed``; ``blocks``, one
entry a pattern position, each leaf stacked over the periods (``ln1``,
``mixer``, ``ln2``, ``ffn``); ``final_norm``; ``unembed`` unless the
embeddings are tied.  An RMSNorm's weight is stored less one (``g``; the
norm multiplies by ``1 + g``), as the program stores it.  Matrices are
drawn N(0, ``initializer_range``), the published initialisation; norm
weights ``1 + N(0, GAIN_STD)`` (an assumption: trained norms are not all
ones, and a forward that skipped one would otherwise agree).  Every leaf
is rounded to the configuration's ``torch_dtype``, the type the weights
are published in; the program is handed them in that type, as a
checkpoint is loaded, the reference in float32.

The block is pre-norm: ``x + mixer(norm(x))``, then ``x + ffn(norm(x))``;
then the final norm and the logits ``x @ unembed.T``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import math
import os

import numpy as np
import torch

GAIN_STD = 0.1
_DRAW = 1 << 30  # parameters drawn at once
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _load(path: str):
    name = "hbench_reference_layer_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def part_file(layers_dir: str, config: str, part: str) -> str:
    """The file of ``part`` for the configuration named ``config``: its
    own, ``<config>/<part>.py``, where there is one, else the shared one."""
    own = os.path.join(layers_dir, config, part + ".py")
    return own if os.path.isfile(own) else os.path.join(layers_dir, part + ".py")


class Decoder:
    """The configuration ``c`` with its layer parts from ``layers_dir``."""

    def __init__(self, c: dict, layers_dir: str):
        self.c = c
        self.pattern = [kind.split("+") for kind in c["pattern"]]
        depth = int(c["num_hidden_layers"])
        if depth % len(self.pattern):
            raise ValueError(f"{depth} layers are no whole number of periods of {c['pattern']}")
        self.periods = depth // len(self.pattern)
        names = {part for kind in self.pattern for part in kind}
        self.parts = {n: _load(part_file(layers_dir, c["name"], n)) for n in sorted(names)}
        self.eps = float(c["rms_norm_eps"])

    # ---- the tree ------------------------------------------------------
    def spec(self) -> list[tuple[tuple, tuple, float]]:
        """``(path, shape, std)`` of every leaf, in the order drawn."""
        c, d, V = self.c, int(self.c["hidden_size"]), int(self.c["vocab_size"])
        std = float(c["initializer_range"])
        out = [(("embed",), (V, d), std)]
        R = self.periods
        for i, (mixer, ffn) in enumerate(self.pattern):
            out.append((("blocks", i, "ln1", "g"), (R, d), GAIN_STD))
            out += [(("blocks", i, "mixer", k), (R, *s), sd) for k, (s, sd) in self.parts[mixer].params(c).items()]
            out.append((("blocks", i, "ln2", "g"), (R, d), GAIN_STD))
            out += [(("blocks", i, "ffn", k), (R, *s), sd) for k, (s, sd) in self.parts[ffn].params(c).items()]
        out.append((("final_norm", "g"), (d,), GAIN_STD))
        if not c.get("tie_word_embeddings", False):
            out.append((("unembed",), (V, d), std))
        return out

    def make_params(self, seed: int, device, dtype: torch.dtype = torch.float32) -> dict:
        """The tree drawn from ``seed`` on ``device``, its leaves views of
        one buffer of ``dtype``: N(0, 1) values drawn by a
        ``torch.Generator`` there in calls of ``_DRAW``, each scaled by
        its leaf's std and rounded to ``torch_dtype``.  The values do not
        depend on ``dtype``."""
        spec = self.spec()
        sizes = [math.prod(shape) for _, shape, _ in spec]
        ends = np.cumsum(sizes).tolist()
        total = ends[-1]
        buf = torch.empty(total, dtype=dtype, device=device)
        g = torch.Generator(device=device)
        g.manual_seed(int(seed) % (1 << 63))
        served = DTYPES[self.c["torch_dtype"]]
        z = torch.empty(min(_DRAW, total), dtype=torch.float32, device=device)
        leaf = 0
        for at in range(0, total, _DRAW):
            n = min(_DRAW, total - at)
            z[:n].normal_(generator=g)
            while leaf < len(spec) and ends[leaf] - sizes[leaf] < at + n:
                lo, hi = max(ends[leaf] - sizes[leaf], at), min(ends[leaf], at + n)
                buf[lo:hi] = (z[lo - at : hi - at] * spec[leaf][2]).to(served)
                if ends[leaf] > at + n:
                    break
                leaf += 1
        del z
        tree: dict = {}
        for (path, shape, _), n, end in zip(spec, sizes, ends):
            node = tree
            for key in path[:-1]:
                if isinstance(key, int):
                    while len(node) <= key:
                        node.append({})
                    node = node[key]
                else:
                    node = node.setdefault(key, [] if key == "blocks" else {})
            node[path[-1]] = buf[end - n : end].view(shape)
        return tree

    # ---- the forward ---------------------------------------------------
    def norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * (1.0 + g)

    def logits(self, params: dict, tokens: torch.Tensor, score_from: int, w=None) -> torch.Tensor:
        """Float32 logits ``(n, S - score_from, V)`` of ``tokens`` ``(n,
        S)``, every position from 0 seeing those before it; ``w(leaf,
        tensor)`` stands between a block matrix and its use."""
        w = w or (lambda name, t: t)
        x = params["embed"][tokens.long()].float()
        for r in range(self.periods):
            for i, (mixer, ffn) in enumerate(self.pattern):
                b = params["blocks"][i]
                p = {k: v[r] for k, v in b["mixer"].items()}
                x = x + self.parts[mixer].apply(self.c, p, self.norm(x, b["ln1"]["g"][r]), w)
                p = {k: v[r] for k, v in b["ffn"].items()}
                x = x + self.parts[ffn].apply(self.c, p, self.norm(x, b["ln2"]["g"][r]), w)
        x = self.norm(x[:, score_from:], params["final_norm"]["g"])
        unembed = params["embed"] if self.c.get("tie_word_embeddings", False) else params["unembed"]
        return x @ unembed.T


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products in float32: TF32 off, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8_rounded(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale a matrix (its largest
    magnitude to e4m3's 448): the control's weights."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def token_gaps(dec: Decoder, params: dict, seqs: np.ndarray, prompt: int, device, rows: int,
               control: bool = False) -> np.ndarray:
    """Each served token's gap below the reference's best, in standard
    deviations of the reference's logits at its position, ``(n, new)``.

    ``seqs`` ``(n, prompt + new)``: prompts and the tokens served after
    them.  The reference reads ``seqs[:, :-1]`` whole and scores the
    positions ``prompt - 1`` onwards, each against the token that
    follows it.  With ``control`` the token judged at each position is
    the one the control (the reference on float8 block weights) puts
    first there, in place of the served one."""
    out = []
    for a in range(0, seqs.shape[0], rows):
        block = torch.from_numpy(seqs[a : a + rows].astype(np.int64)).to(device)
        ref = dec.logits(params, block[:, :-1], prompt - 1)
        if control:
            mats = {n for part in dec.parts.values() for n in part.matrices}
            ctl = dec.logits(params, block[:, :-1], prompt - 1, lambda n, t: fp8_rounded(n, t) if n in mats else t)
            tok = ctl.argmax(-1)
            del ctl
        else:
            tok = block[:, prompt:]
        best = ref.max(-1).values
        got = torch.gather(ref, -1, tok[..., None])[..., 0]
        out.append(((best - got) / ref.std(-1)).cpu().numpy())
        del ref
    return np.concatenate(out)
