"""The bytes one mixed-precision LANS update needs: each buffer once read
and once written at the dtypes the configuration states.

Per parameter: the gradient read (grad_dtype), both moments read and
written (moment_dtype), the master read and written (master_dtype), and,
for a leaf kept in param_dtype below the master's, its low-precision copy
written. A leaf the policy keeps in float32 is its own master.
"""
from __future__ import annotations

import math

SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def kept_fp32(path: str, keep) -> bool:
    low = path.lower()
    return any(s in low for s in keep)


def update_bytes(conf: dict, layout) -> float:
    """`layout`: (path, shape, init) of every leaf (reference.<kind>.
    param_layout)."""
    pr = conf["precision"]
    g, mom, master = (SIZE[pr["grad_dtype"]], SIZE[pr["moment_dtype"]],
                      SIZE[pr["master_dtype"]])
    lp = SIZE[pr["param_dtype"]]
    total = 0
    for path, shape, _ in layout:
        n = math.prod(shape)
        per = g + 4 * mom + 2 * master
        if not kept_fp32(path, pr["keep_fp32"]) and lp < master:
            per += lp
        total += n * per
    return float(total)
