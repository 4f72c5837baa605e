"""Render a model's module graph to Graphviz dot + a parameter summary.

The analogue of the reference's net visualization devtools
(caffe2/python/net_drawer.py GetPydotGraph over NetDef ops, and the mint web
UI caffe2/python/mint/): there is no op-graph NetDef here — XLA owns the op
graph (dump it with utils.net_info.dump_hlo) — so what a human wants to see
is the MODULE graph: backbone stages -> FPN laterals/topdown -> heads, with
parameter counts per module.

Usage:
  python -m sad_tpu.tools.net_drawer --cfg cfg.yaml [--out model.dot]
      [--summary] [KEY VALUE ...]

The dot output renders with any graphviz (`dot -Tpdf model.dot -o model.pdf`);
no graphviz python dependency is needed to WRITE it.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import jax
import numpy as np

from sad_tpu.config import load_cfg
from sad_tpu.utils.logging import setup_logging

logger = setup_logging("net_drawer")


def module_table(params: Any, depth: int = 2) -> Dict[str, int]:
    """Aggregate param counts by module scope, `depth` path levels deep
    (the backbone nests under the FPN module, so depth=1 is too
    coarse to be a drawing)."""
    counts: Dict[str, int] = defaultdict(int)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        scope = "/".join(keys[:depth]) if keys else "?"
        counts[scope] += int(np.prod(leaf.shape)) if leaf.shape else 1
    return dict(counts)


def _wiring_edges(cfg, modules: List[str]) -> List[Tuple[str, str]]:
    """Dataflow edges between top-level modules, from the known builder
    wiring (models/arch.py + models/rcnn.py): body stages feed FPN, FPN
    feeds every head; C4 trunks feed heads directly."""
    edges = []
    has = set(modules)

    def _link(a, b):
        if a in has and b in has:
            edges.append((a, b))

    stage_like = sorted(
        m for m in has
        if m.split("/")[-1].startswith(("res", "conv", "vgg", "body"))
        and not any(k in m.lower() for k in ("lateral", "topdown", "post", "p6", "p7"))
    )
    prev = None
    for m in stage_like:
        if prev is not None:
            _link(prev, m)
        prev = m
    fpn = [
        m for m in has
        if any(k in m.lower() for k in ("lateral", "topdown", "post", "p6", "p7"))
    ]
    heads = [
        m for m in has
        if any(k in m.lower() for k in (
            "cls", "bbox", "retnet", "mask", "kps", "rpn", "head", "score",
        ))
        and m not in fpn
    ]
    src = fpn[0] if fpn else (stage_like[-1] if stage_like else None)
    for f in fpn:
        if stage_like:
            _link(stage_like[-1], f)
    if src:
        for h in heads:
            _link(src, h)
    return edges


def to_dot(cfg, params: Any, title: str = "sad_tpu model") -> str:
    counts = module_table(params)
    modules = sorted(counts)
    lines = [
        "digraph model {",
        "  rankdir=TB;",
        f'  label="{title}  ({sum(counts.values()):,} params)";',
        "  node [shape=box, style=rounded, fontname=Helvetica];",
    ]
    for m in modules:
        lines.append(f'  "{m}" [label="{m}\\n{counts[m]:,} params"];')
    for a, b in _wiring_edges(cfg, modules):
        lines.append(f'  "{a}" -> "{b}";')
    lines.append("}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--out", default="model.dot")
    p.add_argument("--summary", action="store_true",
                   help="also print the per-parameter table")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    cfg = load_cfg(args.cfg_file, args.opts or None)
    from sad_tpu.models import create_model
    from sad_tpu.models.model_builder import init_model_params

    model = create_model(cfg)
    # abstract init: shapes only, no compile/device work
    params = jax.eval_shape(
        lambda: init_model_params(model, jax.random.PRNGKey(0), (1, 128, 128, 3))
    )
    dot = to_dot(cfg, params, title=f"{cfg.MODEL.TYPE}:{cfg.MODEL.CONV_BODY}")
    with open(args.out, "w") as f:
        f.write(dot)
    logger.info("Wrote %s (%d modules)", args.out, len(module_table(params)))
    if args.summary:
        from sad_tpu.utils.net_info import print_model_summary

        print_model_summary(params)
    return args.out


if __name__ == "__main__":
    main()
