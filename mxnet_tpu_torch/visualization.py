"""Network visualization (ref: python/mxnet/visualization.py); the port's
copy of ``mxnet_tpu/visualization.py``."""
from __future__ import annotations

import json

from .base import MXNetError


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64, .74, 1.)):
    """Print a table summary of the symbol graph."""
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    if shape is not None:
        show_shape = True
        _, out_shapes, _ = symbol.get_internals().infer_shape(**shape)
        shape_dict = dict(zip(symbol.get_internals().list_outputs(), out_shapes))
    else:
        show_shape = False
    line_length = int(line_length)
    positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)
    total_params = 0
    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        pre_nodes = [nodes[item[0]]["name"] for item in node["inputs"]]
        out_shape = ""
        if show_shape:
            key = name + "_output"
            if key in shape_dict:
                out_shape = str(shape_dict[key])
        num_params = 0
        print_row([name + " (" + op + ")", out_shape, num_params,
                   ",".join(pre_nodes)], positions)
    print("=" * line_length)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz plot; returns a graphviz.Digraph if graphviz is available."""
    node_attrs = dict(node_attrs or {})
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires the graphviz package, which "
                         "is not installed; use print_summary instead")
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    dot = Digraph(name=title)
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null" and hide_weights and (
                name.endswith("_weight") or name.endswith("_bias") or
                name.endswith("_gamma") or name.endswith("_beta") or
                name.endswith("_moving_mean") or name.endswith("_moving_var")):
            continue
        dot.node(name=name, label="%s\n%s" % (name, op if op != "null" else "var"))
    for node in nodes:
        if node["op"] == "null":
            continue
        for item in node["inputs"]:
            src = nodes[item[0]]["name"]
            dot.edge(tail_name=src, head_name=node["name"])
    return dot
