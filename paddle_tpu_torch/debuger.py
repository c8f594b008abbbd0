"""Program debugging/visualization (reference: python/paddle/fluid/debuger.py
[sic] + graphviz.py + net_drawer.py).

``pprint_program_codes`` renders a Program as pseudo-code; ``draw_block_graphviz``
emits a Graphviz dot file of the op/var dataflow.  Pure text emitters — no
graphviz binary required (the reference also only writes the .dot).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["pprint_program_codes", "pprint_block_codes",
           "draw_block_graphviz", "program_to_code"]


def _fmt_attr(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, str):
        return repr(v)
    if isinstance(v, (list, tuple)) and len(v) > 8:
        return f"[{len(v)} items]"
    return str(v)


def _op_line(op):
    outs = ", ".join(n for ns in op.desc.outputs.values() for n in ns)
    ins = ", ".join(f"{slot}={ns}" for slot, ns in op.desc.inputs.items()
                    if ns)
    attrs = ", ".join(f"{k}={_fmt_attr(v)}"
                      for k, v in sorted(op.desc.attrs.items())
                      if k not in ("op_role",))
    line = f"{outs or '_'} = {op.type}({ins})"
    if attrs:
        line += f"  # {attrs}"
    return line


def pprint_block_codes(block, show_backward=False):
    """One block → readable pseudo-code (debuger.py pprint_block_codes)."""
    lines = [f"block_{block.idx} {{"]
    for var in block.vars.values():
        kind = "param" if getattr(var, "trainable", None) is not None else "var"
        persist = " persistable" if var.persistable else ""
        lines.append(f"  {kind} {var.name} : {var.dtype} "
                     f"shape={list(var.shape or [])}{persist}")
    for op in block.ops:
        role = op.desc.attrs.get("op_role", "forward")
        if not show_backward and role != "forward":
            lines.append(f"  # [{role}] {op.type}(...)")
            continue
        lines.append("  " + _op_line(op))
    lines.append("}")
    return "\n".join(lines)


def pprint_program_codes(program, show_backward=False):
    return "\n\n".join(pprint_block_codes(b, show_backward)
                       for b in program.blocks)


program_to_code = pprint_program_codes


def draw_block_graphviz(block, highlights: Optional[list] = None,
                        path: str = "./temp.dot"):
    """Emit a graphviz dot of a block's dataflow (debuger.py
    draw_block_graphviz): ellipse var nodes, box op nodes, edges in/out."""
    highlights = set(highlights or [])
    lines = ["digraph G {", "  rankdir=TB;"]
    var_ids = {}

    def var_node(name):
        if name not in var_ids:
            var_ids[name] = f"var_{len(var_ids)}"
            color = "orange" if name in highlights else "lightblue"
            lines.append(f'  {var_ids[name]} [label="{name}" shape=ellipse '
                         f'style=filled fillcolor={color}];')
        return var_ids[name]

    for i, op in enumerate(block.ops):
        op_id = f"op_{i}"
        lines.append(f'  {op_id} [label="{op.type}" shape=box '
                     f'style=filled fillcolor=palegreen];')
        for ns in op.desc.inputs.values():
            for n in ns:
                lines.append(f"  {var_node(n)} -> {op_id};")
        for ns in op.desc.outputs.values():
            for n in ns:
                lines.append(f"  {op_id} -> {var_node(n)};")
    lines.append("}")
    dot = "\n".join(lines)
    with open(path, "w") as f:
        f.write(dot)
    return dot
