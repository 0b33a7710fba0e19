"""mx.viz — network summaries (the port of ``mxnet_tpu/visualization.py``).

ref: python/mxnet/visualization.py — ``print_summary`` (layer table with
output shapes and parameter counts) and ``plot_network`` (graphviz).
``print_summary`` works on Gluon blocks (the block tree and one hooked
forward) and on Symbols; ``plot_network`` returns the DOT source, the
JAX package's text for the same symbol (no graphviz binary needed).
"""
from __future__ import annotations

__all__ = ["print_summary", "plot_network"]


def print_summary(block, shape=None, **kwargs):
    """Print a layer-by-layer summary of a Gluon block OR an mx.sym Symbol.

    ``shape``: optional input shape (or list/dict of shapes) INCLUDING the
    batch dim, e.g. ``(1, 3, 224, 224)`` — mirrors the reference's shape
    dict.  For a Block, ``Block.summary`` runs one hooked forward; for a
    Symbol the table walks the graph nodes with shapes from
    ``infer_shape`` (ref: visualization.print_summary over symbols).
    """
    import numpy as np

    from . import ndarray as nd
    from . import symbol as _symbol

    if isinstance(block, _symbol.Symbol):
        return _print_symbol_summary(block, shape)
    if shape is None:
        return block.summary()
    shapes = shape if isinstance(shape, (list, tuple)) and shape and \
        isinstance(shape[0], (list, tuple)) else [shape]
    inputs = [nd.array(np.zeros(s, np.float32)) for s in shapes]
    return block.summary(*inputs)


def _print_symbol_summary(sym, shape=None):
    """Node table for a Symbol: name, op, output shape, param count.

    Shapes come from ONE walk on meta tensors over the whole graph
    (every node's first output via get_internals), not per-node prefix
    traces.
    ``shape``: a tuple, a list of tuples (zipped with the graph's data
    variables in order), or a {var: shape} dict."""
    from .symbol import (Group, data_variables, infer_arg_shapes,
                         label_variables)
    from .executor import abstract_eval

    known = {}
    if isinstance(shape, dict):
        known = {k: tuple(v) for k, v in shape.items()}
    elif shape is not None:
        shapes = shape if isinstance(shape, (list, tuple)) and shape and \
            isinstance(shape[0], (list, tuple)) else [shape]
        known = dict(zip(data_variables(sym), (tuple(s) for s in shapes)))
    arg_shapes, node_shape = {}, {}
    try:
        arg_shapes = infer_arg_shapes(sym, known)
        internals = sym.get_internals()._outputs_list()
        outs, _ = abstract_eval(Group(internals), arg_shapes)
        node_shape = {id(s._node): tuple(o.shape)
                      for s, o in zip(internals, outs)}
    except Exception:
        arg_shapes, node_shape = {}, {}  # unknown: the table prints '?'
    labels = label_variables(sym)
    args = set(sym.list_arguments()) | set(sym.list_auxiliary_states())
    total = 0
    rows = [("Layer (op)", "Output shape", "Params")]
    for node in sym._topo_nodes():
        if node.op is None:
            continue
        out_shape = str(node_shape.get(id(node), "?"))
        n_params = 0
        for s in node.inputs:
            nn = s._node
            if nn.op is None and nn.name in args and \
                    nn.name not in labels and \
                    nn.name in arg_shapes and nn.name not in known:
                p = 1
                for d in arg_shapes[nn.name]:
                    p *= int(d)
                n_params += p
        total += n_params
        rows.append((f"{node.name} ({node.op})", out_shape, str(n_params)))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    for i, r in enumerate(rows):
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        if i == 0:
            print("-" * (sum(widths) + 4))
    print(f"Total params: {total}")
    return total


class _Digraph:
    """Minimal graphviz.Digraph stand-in: holds DOT source; ``render``
    writes the .dot file (rendering to png/pdf needs the graphviz binary,
    which this image does not ship — view the .dot anywhere)."""

    def __init__(self, source: str, name: str = "plot"):
        self.source = source
        self.name = name

    def render(self, filename=None, format=None, **kwargs):  # noqa: A002
        path = f"{filename or self.name}.dot"
        with open(path, "w") as f:
            f.write(self.source)
        return path

    def _repr_mimebundle_(self, *a, **k):  # notebook-friendly
        return {"text/plain": self.source}


_NODE_STYLE = {
    None: ("ellipse", "#8dd3c7"),          # variables
    "Convolution": ("box", "#fb8072"),
    "FullyConnected": ("box", "#fb8072"),
    "BatchNorm": ("box", "#bebada"),
    "Activation": ("box", "#ffffb3"),
    "Pooling": ("box", "#80b1d3"),
    "SoftmaxOutput": ("box", "#fccde5"),
}


def _dot_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def plot_network(symbol, title="plot", shape=None, hide_weights=True,
                 **kwargs):
    """DOT graph of a Symbol (ref: visualization.plot_network).

    Returns a Digraph-like object whose ``.source`` is DOT text and whose
    ``.render(filename)`` writes ``filename.dot``; the graphviz BINARY is
    not shipped in this image, so rasterising is left to the viewer.
    ``shape`` (same forms as print_summary) annotates each node with its
    output shape, like the reference's shape-labelled edges."""
    known_noop = {"node_attrs", "save_format", "dtype"}  # reference args
    unknown = set(kwargs) - known_noop
    if unknown:
        raise TypeError(f"plot_network: unknown arguments {sorted(unknown)} "
                        f"(did you mean hide_weights/shape/title?)")
    from .symbol import Symbol, Group, infer_arg_shapes, data_variables
    from .executor import abstract_eval

    if not isinstance(symbol, Symbol):
        raise TypeError("plot_network expects an mx.sym Symbol; for Gluon "
                        "blocks use print_summary")
    node_shape = {}
    if shape is not None:
        if isinstance(shape, dict):
            known = {k: tuple(v) for k, v in shape.items()}
        else:
            shapes = shape if isinstance(shape, (list, tuple)) and shape \
                and isinstance(shape[0], (list, tuple)) else [shape]
            known = dict(zip(data_variables(symbol),
                             (tuple(s) for s in shapes)))
        arg_shapes = infer_arg_shapes(symbol, known)   # raises on mismatch
        internals = symbol.get_internals()._outputs_list()
        outs, _ = abstract_eval(Group(internals), arg_shapes)
        node_shape = {id(s._node): tuple(o.shape)
                      for s, o in zip(internals, outs)}
        node_shape.update({id(n): arg_shapes.get(n.name)
                           for n in symbol._topo_nodes() if n.op is None})
    lines = [f'digraph "{_dot_escape(title)}" {{', "  rankdir=BT;"]
    nodes = symbol._topo_nodes()
    idx = {id(n): i for i, n in enumerate(nodes)}
    hidden = set()
    for n in nodes:
        if n.op is None and hide_weights and n.inputs == [] and \
                any(n.name.endswith(s) for s in
                    ("_weight", "_bias", "_gamma", "_beta", "_moving_mean",
                     "_moving_var", "parameters")):
            hidden.add(id(n))
            continue
        shape_, color = _NODE_STYLE.get(n.op, ("box", "#d9d9d9"))
        label = n.name if n.op is None else f"{n.name}\n{n.op}"
        if node_shape.get(id(n)):
            label += f"\n{node_shape[id(n)]}"
        lines.append(f'  n{idx[id(n)]} '
                     f'[label="{_dot_escape(label)}" shape={shape_} '
                     f'style=filled fillcolor="{color}"];')
    for n in nodes:
        for s in n.inputs:
            if id(s._node) in hidden:
                continue
            lines.append(f"  n{idx[id(s._node)]} -> n{idx[id(n)]};")
    lines.append("}")
    return _Digraph("\n".join(lines), name=title)
