"""Each cell cut to a size the CPU tests run in about a second: the same
loops, adapters, reference and checks, on the plain versions of the
program's kernels (``device="cpu"``).

A cell's tiny sizes are found by name, as its full-size parts are:
``tiny/configs/<config>.json``, ``tiny/traffic/<traffic>.json`` and
``tiny/limits/<workload>.json``, each ``{"overrides": {key: value},
"why": ...}``, the keys that replace the full-size file's.  A limit that
depends on the size (a served model's logit gap) is set anew for the tiny
size in its limits file."""
from __future__ import annotations

import json
import os

from hbench import harness

# part of a run -> the folder under tiny/ and the cell's key that names its file
PARTS = {"config": ("configs", "config"), "traffic": ("traffic", "traffic"), "limits": ("limits", "name")}


class LayoutError(LookupError):
    """A cell lacks one of its tiny files."""


def overrides(cell: dict, root: str = harness.ROOT) -> dict:
    """The tiny sizes of ``cell`` in the checkout ``root``: ``{"config":
    ..., "traffic": ..., "limits": ...}``, for ``harness.run_cell``."""
    out = {}
    for part, (folder, key) in PARTS.items():
        path = harness.part_path(root, os.path.join("tiny", folder), cell[key], ".json")
        if not os.path.isfile(path):
            raise LayoutError(f"cell {cell['name']!r} has no tiny {part} file {path}")
        with open(path) as f:
            out[part] = json.load(f)["overrides"]
    return out
