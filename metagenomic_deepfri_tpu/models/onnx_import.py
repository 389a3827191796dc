"""ONNX graph execution and DeepFRI weight import.

Two roles:

1. :class:`OnnxExecutor` — an eager evaluator for the operator subset that
   tf2onnx emits for the DeepFRI Keras models (MatMul/Gemm, LSTM, Conv,
   activations, reductions, reshapes). It is the *parity oracle*: the JAX
   forwards in :mod:`.deepfri` are validated against it per-layer, replacing
   the reference's onnxruntime-based oracle (reference
   ``weight_convert/README.md:5-6`` validated TF2 vs ONNX the same way).

2. Weight import/export — :func:`import_gcn_params` / :func:`import_cnn_params`
   map a parsed ONNX graph's initializers onto our parameter trees by
   topological shape-matching; ``export_*_to_onnx`` serialise our parameter
   trees into equivalent ONNX graphs (round-trip test fixtures, and an escape
   hatch back to the reference toolchain).

ONNX LSTM gate order is ``[i, o, f, c]``; ours (Keras layout) is
``[i, f, c, o]`` — conversion happens here so :mod:`.lstm` stays clean.
"""

from __future__ import annotations

import numpy as np

from metagenomic_deepfri_tpu.models.deepfri import CNNConfig, GCNConfig
from metagenomic_deepfri_tpu.models.onnx_reader import (DTYPE_MAP, OnnxGraph,
                                                        OnnxNode, save_onnx)

_F32 = 1  # TensorProto.FLOAT


# ---------------------------------------------------------------------------
# Graph normalisation (tf2onnx noise folding)
# ---------------------------------------------------------------------------

def normalize_graph(graph: OnnxGraph) -> OnnxGraph:
    """Fold exporter noise so import sees a clean dataflow graph.

    Real published DeepFRI weights are tf2onnx opset-15 exports of TF2 Keras
    models (reference ``weight_convert/convert_models2onnx.py:41-45``); those
    graphs carry Constant nodes, Identity chains, and Cast/Transpose wrappers
    around weight initializers. This pass (idempotent, in place):

    * ``Constant`` nodes → initializers,
    * ``Identity`` nodes → removed, consumers rewired to the source,
    * ``Cast``/``Transpose`` of an initializer → folded into a new
      initializer under the node's output name.

    The :class:`OnnxExecutor` does NOT need this — it evaluates the raw
    graph — so the parity oracle stays independent of the folding logic.
    """
    rename: dict[str, str] = {}
    kept: list[OnnxNode] = []
    for node in graph.nodes:  # ONNX requires topological node order
        node.inputs = [rename.get(i, i) for i in node.inputs]
        if node.op_type == "Constant" and "value" in node.attributes:
            graph.initializers[node.outputs[0]] = np.asarray(
                node.attributes["value"])
            continue
        if node.op_type == "Identity":
            src = node.inputs[0]
            if src in graph.initializers:
                graph.initializers[node.outputs[0]] = \
                    graph.initializers[src]
            else:
                rename[node.outputs[0]] = src
            continue
        if (node.op_type == "Cast"
                and node.inputs[0] in graph.initializers):
            src = graph.initializers[node.inputs[0]]
            graph.initializers[node.outputs[0]] = src.astype(
                DTYPE_MAP[node.attributes["to"]])
            continue
        if (node.op_type == "Transpose"
                and node.inputs[0] in graph.initializers):
            src = graph.initializers[node.inputs[0]]
            graph.initializers[node.outputs[0]] = np.transpose(
                src, node.attributes.get("perm"))
            continue
        kept.append(node)
    graph.nodes = kept
    for vi in graph.outputs:
        vi.name = rename.get(vi.name, vi.name)
    return graph


def graph_input_roles(graph: OnnxGraph, vocab: int = 26) -> dict:
    """Resolve the graph's runtime input names to DeepFRI roles by shape.

    tf2onnx names inputs after the Keras layers (``input_1``/``input_2``)
    rather than the reference's ``A``/``S`` convention, and symbolic dims of
    the square adjacency may carry *different* placeholder names
    (``unk__0`` × ``unk__1``) — so roles are resolved structurally: the
    rank-3 input with trailing dim ``vocab`` is the sequence ``S``; any other
    rank-3 input is the adjacency ``A``.
    """
    roles: dict = {"S": None, "A": None}
    for vi in graph.inputs:
        if len(vi.shape) == 3 and vi.shape[-1] == vocab:
            roles["S"] = vi.name
    for vi in graph.inputs:
        if vi.name != roles["S"] and len(vi.shape) == 3:
            roles["A"] = vi.name
    if roles["S"] is None:
        raise ValueError(
            f"No (1, L, {vocab}) sequence input found among graph inputs "
            f"{[(vi.name, vi.shape) for vi in graph.inputs]}")
    return roles


def _lstm_tensor(graph: OnnxGraph, name: str, what: str) -> np.ndarray:
    if name and name in graph.initializers:
        return np.asarray(graph.initializers[name], np.float32)
    raise ValueError(
        f"LSTM {what} '{name}' is not a graph initializer — run "
        f"normalize_graph() on the graph before importing weights")


def _producer_map(graph: OnnxGraph) -> dict:
    return {out: node for node in graph.nodes for out in node.outputs if out}


def _consumer_map(graph: OnnxGraph) -> dict:
    consumers: dict[str, list[OnnxNode]] = {}
    for node in graph.nodes:
        for i in node.inputs:
            if i:
                consumers.setdefault(i, []).append(node)
    return consumers


# Layout-only ops a tensor can be traced through without changing identity
# for structural matching purposes.
_LAYOUT_OPS = frozenset({"Squeeze", "Unsqueeze", "Transpose", "Identity",
                         "Reshape"})


def _canon(producers: dict, tensor: str) -> str:
    """Trace a tensor back through layout-only ops to a canonical source."""
    seen = set()
    while tensor in producers and tensor not in seen:
        seen.add(tensor)
        node = producers[tensor]
        if node.op_type not in _LAYOUT_OPS:
            break
        tensor = node.inputs[0]
    return tensor


def _revseq_source(producers: dict, tensor: str):
    """If ``tensor`` is (through layout ops) the ReverseSequence of another
    tensor, return that source canonicalised; else None."""
    seen = set()
    while tensor in producers and tensor not in seen:
        seen.add(tensor)
        node = producers[tensor]
        if node.op_type == "ReverseSequence":
            return _canon(producers, node.inputs[0])
        if node.op_type not in _LAYOUT_OPS:
            return None
        tensor = node.inputs[0]
    return None


def _flows_into_reverse(consumers: dict, tensor: str) -> bool:
    """True if the tensor reaches a ReverseSequence through layout ops."""
    stack, seen = [tensor], set()
    while stack:
        t = stack.pop()
        if t in seen:
            continue
        seen.add(t)
        for node in consumers.get(t, []):
            if node.op_type == "ReverseSequence":
                return True
            if node.op_type in _LAYOUT_OPS:
                stack.extend(node.outputs)
    return False


def collect_lstm_layers(graph: OnnxGraph) -> list:
    """Group a graph's LSTM nodes into model layers as (W, R, B) triples.

    tf2onnx exports a Keras ``Bidirectional(LSTM)`` in one of three forms:

    1. ONE node with ``direction='bidirectional'``;
    2. TWO unidirectional nodes — a ``forward`` and a ``reverse`` one reading
       the same input, concatenated downstream;
    3. TWO ``forward`` nodes where the backward branch wraps its mate's input
       in a ``ReverseSequence`` and re-reverses its own output (the exporter's
       alternative lowering of the Keras backward layer).

    Forms 2 and 3 are merged here into a single bidirectional layer with
    W/R/B stacked on the num_directions axis (ONNX order: forward = 0,
    reverse = 1) — for form 3 the re-reversed branch becomes direction 1
    unchanged, since ONNX reverse direction *is* forward-on-reversed-input
    with outputs stored at original positions. Call on a
    :func:`normalize_graph`-ed graph (weights must be initializers).
    """
    producers = _producer_map(graph)
    consumers = _consumer_map(graph)
    entries = []
    for node in graph.nodes:
        if node.op_type != "LSTM":
            continue
        d = node.attributes.get("direction", b"forward")
        if isinstance(d, bytes):
            d = d.decode()
        W = _lstm_tensor(graph, node.inputs[1], "W")
        R = _lstm_tensor(graph, node.inputs[2], "R")
        B = (_lstm_tensor(graph, node.inputs[3], "B")
             if len(node.inputs) > 3 and node.inputs[3]
             else np.zeros((W.shape[0], 8 * R.shape[-1]), np.float32))
        entries.append({
            "x": node.inputs[0], "dir": d, "W": W, "R": R, "B": B,
            "xc": _canon(producers, node.inputs[0]),
            "rev_of": _revseq_source(producers, node.inputs[0]),
            "rereversed": _flows_into_reverse(consumers, node.outputs[0]),
        })
    layers = []
    used = [False] * len(entries)
    for i, e in enumerate(entries):
        if used[i]:
            continue
        used[i] = True
        if e["W"].shape[0] == 2 or e["dir"] == "bidirectional":
            layers.append((e["W"], e["R"], e["B"]))
            continue
        mate = None
        e_is_fwd = True
        for j, m in enumerate(entries):
            if used[j] or j == i or m["W"].shape[0] != 1:
                continue
            if (m["xc"] == e["xc"]
                    and {e["dir"], m["dir"]} == {"forward", "reverse"}):
                mate, e_is_fwd = j, e["dir"] == "forward"
                break
            if e["dir"] == "forward" and m["dir"] == "forward":
                # ReverseSequence lowering: the backward mate reads the
                # reversed input and re-reverses its output.
                if (m["rev_of"] is not None and m["rev_of"] == e["xc"]
                        and e["rev_of"] is None and m["rereversed"]):
                    mate, e_is_fwd = j, True
                    break
                if (e["rev_of"] is not None and e["rev_of"] == m["xc"]
                        and m["rev_of"] is None and e["rereversed"]):
                    mate, e_is_fwd = j, False
                    break
        if mate is None:
            layers.append((e["W"], e["R"], e["B"]))
            continue
        used[mate] = True
        m = entries[mate]
        fwd, bwd = (e, m) if e_is_fwd else (m, e)
        layers.append((np.concatenate([fwd["W"], bwd["W"]], axis=0),
                       np.concatenate([fwd["R"], bwd["R"]], axis=0),
                       np.concatenate([fwd["B"], bwd["B"]], axis=0)))
    return layers


# ---------------------------------------------------------------------------
# Gate-order conversion helpers
# ---------------------------------------------------------------------------

def _iofc_to_ifco(w_4h: np.ndarray, hidden: int) -> np.ndarray:
    """Reorder the 4H gate axis (axis 0) from ONNX [i,o,f,c] to ours [i,f,c,o]."""
    i, o, f, c = (w_4h[k * hidden:(k + 1) * hidden] for k in range(4))
    return np.concatenate([i, f, c, o], axis=0)


def _ifco_to_iofc(w_4h: np.ndarray, hidden: int) -> np.ndarray:
    i, f, c, o = (w_4h[k * hidden:(k + 1) * hidden] for k in range(4))
    return np.concatenate([i, o, f, c], axis=0)


def _lstm_dir_from_onnx(W, R, B, d: int) -> dict:
    hidden = R.shape[-1]
    kernel = _iofc_to_ifco(W[d], hidden).T          # (D, 4H)
    recurrent = _iofc_to_ifco(R[d], hidden).T        # (H, 4H)
    wb, rb = B[d][:4 * hidden], B[d][4 * hidden:]
    bias = _iofc_to_ifco(wb, hidden) + _iofc_to_ifco(rb, hidden)
    # host numpy by design: imported weights stay on host until the engine
    # fingerprints them (shared-trunk detection) and device-places each
    # tree ONCE, instead of paying one eager device op per leaf.
    return {"kernel": np.ascontiguousarray(kernel),
            "recurrent": np.ascontiguousarray(recurrent),
            "bias": np.ascontiguousarray(bias)}


def lstm_params_from_onnx(W: np.ndarray, R: np.ndarray,
                          B: np.ndarray) -> dict:
    """ONNX LSTM initializers (num_dir, 4H, D), (num_dir, 4H, H),
    (num_dir, 8H) → our layout.

    num_dir=1 → a unidirectional param dict; num_dir=2 (bidirectional) →
    ``{'fwd': ..., 'bwd': ...}`` consumed by
    :func:`..lstm.lstm_bidirectional_forward` (ONNX direction 0 is forward,
    1 is reverse).
    """
    if W.shape[0] == 2:
        return {"fwd": _lstm_dir_from_onnx(W, R, B, 0),
                "bwd": _lstm_dir_from_onnx(W, R, B, 1)}
    return _lstm_dir_from_onnx(W, R, B, 0)


def lstm_params_to_onnx(params: dict) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    hidden = params["recurrent"].shape[0]
    W = _ifco_to_iofc(np.asarray(params["kernel"]).T, hidden)[None]
    R = _ifco_to_iofc(np.asarray(params["recurrent"]).T, hidden)[None]
    wb = _ifco_to_iofc(np.asarray(params["bias"]), hidden)
    B = np.concatenate([wb, np.zeros_like(wb)])[None]
    return W.astype(np.float32), R.astype(np.float32), B.astype(np.float32)


# ---------------------------------------------------------------------------
# Eager graph executor
# ---------------------------------------------------------------------------

class OnnxExecutor:
    """Eagerly evaluate an :class:`OnnxGraph` on named feeds, in numpy.

    The plain reference the JAX models are checked against: it shares no
    code with the JAX path and never touches an accelerator.

    Returns all graph outputs (list), mirroring
    ``onnxruntime.InferenceSession.run(None, feeds)`` (reference
    ``predict.pyx:98``). Intermediate activations can be captured via
    ``trace=True`` for per-layer parity checks.
    """

    def __init__(self, graph: OnnxGraph):
        self.graph = graph
        self.input_names = [vi.name for vi in graph.inputs]

    def run(self, feeds: dict, trace: bool = False):
        env: dict[str, np.ndarray] = {}
        for name, arr in self.graph.initializers.items():
            env[name] = np.asarray(arr)
        for name, arr in feeds.items():
            env[name] = np.asarray(arr)
        traced = {}
        for node in self.graph.nodes:
            outs = self._eval(node, env)
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
                    if trace:
                        traced[name] = val
        results = [env[vi.name] for vi in self.graph.outputs]
        if trace:
            return results, traced
        return results

    # -- op registry --------------------------------------------------------

    def _eval(self, node: OnnxNode, env: dict):
        op = node.op_type
        attrs = node.attributes
        x = [env[i] if i else None for i in node.inputs]

        if op == "MatMul":
            return [np.matmul(x[0], x[1])]
        if op == "Gemm":
            a = x[0].T if attrs.get("transA", 0) else x[0]
            b = x[1].T if attrs.get("transB", 0) else x[1]
            y = attrs.get("alpha", 1.0) * (a @ b)
            if len(x) > 2 and x[2] is not None:
                y = y + attrs.get("beta", 1.0) * x[2]
            return [np.asarray(y)]
        if op == "Add":
            return [x[0] + x[1]]
        if op == "Sub":
            return [x[0] - x[1]]
        if op == "Mul":
            return [x[0] * x[1]]
        if op == "Div":
            return [x[0] / x[1]]
        if op == "Relu":
            return [np.maximum(x[0], 0)]
        if op == "Sigmoid":
            return [np.exp(-np.logaddexp(0, -x[0])).astype(x[0].dtype)]
        if op == "Tanh":
            return [np.tanh(x[0])]
        if op == "Sqrt":
            return [np.sqrt(x[0])]
        if op == "Reciprocal":
            return [1.0 / x[0]]
        if op == "Max":
            y = x[0]
            for other in x[1:]:
                y = np.maximum(y, other)
            return [y]
        if op == "Softmax":
            axis = attrs.get("axis", -1)
            e = np.exp(x[0] - np.max(x[0], axis=axis, keepdims=True))
            return [e / np.sum(e, axis=axis, keepdims=True)]
        if op == "Concat":
            return [np.concatenate(x, axis=attrs["axis"])]
        if op == "Reshape":
            shape = [int(d) for d in x[1]]
            return [x[0].reshape(shape)]
        if op == "Transpose":
            return [np.transpose(x[0], attrs.get("perm"))]
        if op == "Squeeze":
            axes = attrs.get("axes")
            if axes is None and len(x) > 1 and x[1] is not None:
                axes = [int(a) for a in x[1]]
            return [np.squeeze(x[0], axis=tuple(axes) if axes else None)]
        if op == "Unsqueeze":
            axes = attrs.get("axes")
            if axes is None and len(x) > 1 and x[1] is not None:
                axes = [int(a) for a in x[1]]
            y = x[0]
            for a in sorted(axes):
                y = np.expand_dims(y, a)
            return [y]
        if op == "ReduceSum":
            axes = attrs.get("axes")
            if axes is None and len(x) > 1 and x[1] is not None:
                axes = [int(a) for a in x[1]]
            keep = bool(attrs.get("keepdims", 1))
            return [np.sum(x[0], axis=tuple(axes) if axes else None,
                           keepdims=keep)]
        if op == "ReduceMax":
            axes = attrs.get("axes")
            if axes is None and len(x) > 1 and x[1] is not None:
                axes = [int(a) for a in x[1]]
            keep = bool(attrs.get("keepdims", 1))
            return [np.max(x[0], axis=tuple(axes) if axes else None,
                           keepdims=keep)]
        if op == "ReduceMean":
            axes = attrs.get("axes")
            if axes is None and len(x) > 1 and x[1] is not None:
                axes = [int(a) for a in x[1]]
            keep = bool(attrs.get("keepdims", 1))
            return [np.mean(x[0], axis=tuple(axes) if axes else None,
                            keepdims=keep)]
        if op == "Identity":
            return [x[0]]
        if op == "Cast":
            from metagenomic_deepfri_tpu.models.onnx_reader import DTYPE_MAP
            return [x[0].astype(DTYPE_MAP[attrs["to"]])]
        if op == "Constant":
            return [np.asarray(attrs["value"])]
        if op == "Shape":
            # opset 15 supports start/end attrs (negative = from the back)
            dims = np.asarray(x[0].shape, dtype=np.int64)
            start = attrs.get("start", 0)
            end = attrs.get("end")
            return [dims[start:end]]
        if op == "Split":
            axis = attrs.get("axis", 0)
            sizes = attrs.get("split")
            if sizes is None and len(x) > 1 and x[1] is not None:
                sizes = [int(s) for s in x[1]]
            if sizes is None:
                n_out = len(node.outputs)
                return list(np.split(x[0], n_out, axis=axis))
            points = np.cumsum(sizes)[:-1]
            return list(np.split(x[0], points, axis=axis))
        if op == "Expand":
            shape = tuple(int(d) for d in x[1])
            out_shape = np.broadcast_shapes(x[0].shape, shape)
            return [np.broadcast_to(x[0], out_shape)]
        if op == "Where":
            return [np.where(x[0], x[1], x[2])]
        if op == "Pad":
            mode = attrs.get("mode", b"constant")
            if isinstance(mode, bytes):
                mode = mode.decode()
            pads = ([int(p) for p in x[1]] if len(x) > 1 and x[1] is not None
                    else [int(p) for p in attrs.get("pads", [])])
            rank = x[0].ndim
            widths = [(pads[i], pads[i + rank]) for i in range(rank)]
            if mode == "constant":
                cval = (float(x[2]) if len(x) > 2 and x[2] is not None
                        else attrs.get("value", 0.0))
                return [np.pad(x[0], widths, constant_values=cval)]
            if mode in ("reflect", "edge"):
                return [np.pad(x[0], widths, mode=mode)]
            raise NotImplementedError(f"Pad mode {mode}")
        if op == "ConstantOfShape":
            shape = tuple(int(d) for d in x[0])
            value = attrs.get("value")
            if value is None:
                return [np.zeros(shape, np.float32)]
            value = np.asarray(value)
            return [np.full(shape, value.reshape(-1)[0], dtype=value.dtype)]
        if op == "Range":
            return [np.arange(x[0].item(), x[1].item(), x[2].item(),
                              dtype=np.asarray(x[0]).dtype)]
        if op == "Equal":
            return [x[0] == x[1]]
        if op == "Greater":
            return [x[0] > x[1]]
        if op == "Less":
            return [x[0] < x[1]]
        if op == "Not":
            return [~np.asarray(x[0], bool)]
        if op == "And":
            return [np.logical_and(x[0], x[1])]
        if op == "Or":
            return [np.logical_or(x[0], x[1])]
        if op == "Exp":
            return [np.exp(x[0])]
        if op == "Pow":
            return [np.power(x[0], x[1])]
        if op == "Neg":
            return [-x[0]]
        if op == "Min":
            y = x[0]
            for other in x[1:]:
                y = np.minimum(y, other)
            return [y]
        if op == "Clip":
            lo = x[1] if len(x) > 1 and x[1] is not None else attrs.get("min")
            hi = x[2] if len(x) > 2 and x[2] is not None else attrs.get("max")
            return [np.clip(x[0], lo, hi)]
        if op == "Flatten":
            axis = attrs.get("axis", 1)
            lead = int(np.prod(x[0].shape[:axis], dtype=np.int64))
            return [x[0].reshape(lead, -1)]
        if op == "Tile":
            return [np.tile(x[0], [int(r) for r in x[1]])]
        if op == "Gather":
            axis = attrs.get("axis", 0)
            return [np.take(x[0], x[1].astype(np.int64), axis=axis)]
        if op == "Slice":
            starts = [int(v) for v in x[1]]
            ends = [int(v) for v in x[2]]
            axes = ([int(v) for v in x[3]] if len(x) > 3 and x[3] is not None
                    else list(range(len(starts))))
            steps = ([int(v) for v in x[4]] if len(x) > 4 and x[4] is not None
                     else [1] * len(starts))
            slices = [slice(None)] * x[0].ndim
            for s, e, a, st in zip(starts, ends, axes, steps):
                slices[a] = slice(s, e, st)
            return [x[0][tuple(slices)]]
        if op == "ReverseSequence":
            t_ax = attrs.get("time_axis", 0)
            b_ax = attrs.get("batch_axis", 1)
            lens = np.asarray(x[1]).astype(np.int64)
            y = np.moveaxis(np.asarray(x[0]), (t_ax, b_ax), (0, 1)).copy()
            for b in range(y.shape[1]):
                n = int(lens[b])
                y[:n, b] = y[:n, b][::-1]
            return [np.moveaxis(y, (0, 1), (t_ax, b_ax))]
        if op == "Conv":
            return [self._conv(x, attrs)]
        if op == "LSTM":
            return self._lstm(x, attrs)
        if op == "GlobalMaxPool":
            return [np.max(x[0], axis=tuple(range(2, x[0].ndim)),
                           keepdims=True)]
        raise NotImplementedError(f"ONNX op not supported: {op}")

    def _conv(self, x, attrs):
        """N-d Conv with NC(D)(H)W layout (ONNX convention), in numpy."""
        data = np.asarray(x[0], np.float32)
        weight = np.asarray(x[1], np.float32)
        bias = x[2] if len(x) > 2 else None
        spatial = data.ndim - 2
        if attrs.get("group", 1) != 1 or any(
                d != 1 for d in attrs.get("dilations", [1] * spatial)):
            raise NotImplementedError("Conv with groups or dilations")
        strides = attrs.get("strides", [1] * spatial)
        kernel = weight.shape[2:]
        pads = list(attrs.get("pads", [0] * (2 * spatial)))
        auto_pad = attrs.get("auto_pad", b"NOTSET")
        if isinstance(auto_pad, bytes):
            auto_pad = auto_pad.decode()
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            for i in range(spatial):
                n = data.shape[2 + i]
                total = max((-(-n // strides[i]) - 1) * strides[i]
                            + kernel[i] - n, 0)
                small = total // 2
                lo = small if auto_pad == "SAME_UPPER" else total - small
                pads[i], pads[i + spatial] = lo, total - lo
        data = np.pad(data, [(0, 0), (0, 0)] + [
            (pads[i], pads[i + spatial]) for i in range(spatial)])
        win = np.lib.stride_tricks.sliding_window_view(
            data, kernel, axis=tuple(range(2, 2 + spatial)))
        win = win[(slice(None), slice(None))
                  + tuple(slice(None, None, s) for s in strides)]
        # (N, C, *out, *k) · (O, C, *k) → (N, *out, O) → (N, O, *out)
        axes = [1] + list(range(2 + spatial, 2 + 2 * spatial))
        y = np.tensordot(win, weight, axes=(axes, list(range(1, 2 + spatial))))
        y = np.moveaxis(y, -1, 1)
        if bias is not None:
            y = y + bias.reshape((1, -1) + (1,) * spatial)
        return y.astype(np.float32)

    def _lstm(self, x, attrs):
        """ONNX LSTM with full input-list semantics.

        Supports forward / reverse / bidirectional direction, optional
        ``sequence_lens`` (input 4: Y zeroed past each length, final states
        taken at the last valid step, reverse direction processes the valid
        prefix back-to-front — the pattern tf2onnx emits for Keras LSTM) and
        optional ``initial_h``/``initial_c`` (inputs 5/6). Non-default
        activations / clip / layout=1 raise (the DeepFRI exports use the
        defaults).
        """
        X, W, R = x[0], x[1], x[2]
        B = x[3] if len(x) > 3 else None
        seq_lens = x[4] if len(x) > 4 else None
        init_h = x[5] if len(x) > 5 else None
        init_c = x[6] if len(x) > 6 else None
        hidden = attrs["hidden_size"]
        acts = attrs.get("activations")
        if acts:
            names = [a.decode().lower() if isinstance(a, bytes) else
                     str(a).lower() for a in acts]
            if names != ["sigmoid", "tanh", "tanh"] * (len(names) // 3):
                raise NotImplementedError(
                    f"Non-default LSTM activations: {names}")
        if attrs.get("clip") is not None:
            raise NotImplementedError("LSTM clip attribute not supported")
        if attrs.get("layout", 0):
            raise NotImplementedError("LSTM layout=1 not supported")
        direction = attrs.get("direction", b"forward")
        if isinstance(direction, bytes):
            direction = direction.decode()
        num_dir = W.shape[0]
        seq_len, batch, _ = X.shape
        if B is None:
            B = np.zeros((num_dir, 8 * hidden), np.float32)
        lens = (np.full((batch,), seq_len, np.int64) if seq_lens is None
                else np.asarray(seq_lens).astype(np.int64).reshape(batch))
        h0 = (np.zeros((num_dir, batch, hidden), np.float32)
              if init_h is None else np.asarray(init_h, np.float32))
        c0 = (np.zeros((num_dir, batch, hidden), np.float32)
              if init_c is None else np.asarray(init_c, np.float32))

        def run_dir(d, reverse):
            w, r = W[d], R[d]
            wb, rb = B[d][:4 * hidden], B[d][4 * hidden:]
            ys = np.zeros((seq_len, batch, hidden), np.float32)
            h_fin = np.zeros((batch, hidden), np.float32)
            c_fin = np.zeros((batch, hidden), np.float32)
            for b in range(batch):
                T = int(lens[b])
                h = h0[d, b].copy()
                c = c0[d, b].copy()
                order = range(T - 1, -1, -1) if reverse else range(T)
                # input projection of every step in one matmul
                xw = X[:T, b] @ w.T + (wb + rb)
                rt = np.ascontiguousarray(r.T)
                for t in order:
                    gates = xw[t] + h @ rt
                    i = _sigmoid(gates[:hidden])
                    o = _sigmoid(gates[hidden:2 * hidden])
                    f = _sigmoid(gates[2 * hidden:3 * hidden])
                    g = np.tanh(gates[3 * hidden:])
                    c = f * c + i * g
                    h = o * np.tanh(c)
                    ys[t, b] = h
                h_fin[b] = h
                c_fin[b] = c
            return ys, h_fin, c_fin

        dirs = []
        finals_h, finals_c = [], []
        for d in range(num_dir):
            reverse = (direction == "reverse") or (d == 1)
            ys, h, c = run_dir(d, reverse)
            dirs.append(ys)
            finals_h.append(h)
            finals_c.append(c)
        Y = np.stack(dirs, axis=1)               # (seq, num_dir, batch, H)
        Y_h = np.stack(finals_h, axis=0)
        Y_c = np.stack(finals_c, axis=0)
        return [Y, Y_h, Y_c]


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


# ---------------------------------------------------------------------------
# Export (our params → ONNX)
# ---------------------------------------------------------------------------

def export_gcn_to_onnx(params: dict, config: GCNConfig, path: str):
    """Serialise a GCN parameter tree as an ONNX graph.

    The graph mirrors the reference models' I/O contract: inputs
    ``A (1, L, L)``, ``S (1, L, 26)``; output ``(1, n_labels, 2)`` whose
    ``[:, :, 0]`` slice is the score vector (reference predict.pyx:83-102).
    Exported with ``adj_norm='none'`` semantics — the adjacency is consumed
    as fed, so normalisation must be baked by the caller if desired.
    """
    nodes = []
    init: dict[str, np.ndarray] = {}

    # --- sequence branch ---
    nodes.append(OnnxNode("Transpose", ["S"], ["seq_t"], "transpose_in",
                          {"perm": [1, 0, 2]}))
    prev = "seq_t"
    for li, layer in enumerate(params["lm"]):
        W, R, B = lstm_params_to_onnx(layer)
        init[f"lstm{li}_W"] = W
        init[f"lstm{li}_R"] = R
        init[f"lstm{li}_B"] = B
        nodes.append(OnnxNode(
            "LSTM", [prev, f"lstm{li}_W", f"lstm{li}_R", f"lstm{li}_B"],
            [f"lstm{li}_Y", f"lstm{li}_Yh", f"lstm{li}_Yc"], f"LSTM{li + 1}",
            {"hidden_size": config.lm_hidden}))
        nodes.append(OnnxNode("Squeeze", [f"lstm{li}_Y", "axes1"],
                              [f"lstm{li}_sq"], f"lstm{li}_squeeze"))
        prev = f"lstm{li}_sq"
    init["axes1"] = np.asarray([1], np.int64)
    nodes.append(OnnxNode("Transpose", [prev], ["lm_out"], "transpose_out",
                          {"perm": [1, 0, 2]}))

    def dense(prefix, layer, x, relu):
        """MatMul + optional bias Add (+ optional Relu); returns out name."""
        init[f"{prefix}_k"] = np.asarray(layer["kernel"], np.float32)
        nodes.append(OnnxNode("MatMul", [x, f"{prefix}_k"],
                              [f"{prefix}_lin"], prefix))
        cur = f"{prefix}_lin"
        if "bias" in layer:
            init[f"{prefix}_b"] = np.asarray(layer["bias"], np.float32)
            nodes.append(OnnxNode("Add", [cur, f"{prefix}_b"],
                                  [f"{prefix}_biased"], f"{prefix}_bias"))
            cur = f"{prefix}_biased"
        if relu:
            nodes.append(OnnxNode("Relu", [cur], [f"{prefix}_out"],
                                  f"{prefix}_relu"))
            cur = f"{prefix}_out"
        return cur

    x_lm = dense("lm_embed", params["lm_embed"], "lm_out", relu=False)
    x_aa = dense("aa_embed", params["aa_embed"], "S", relu=False)
    nodes.append(OnnxNode("Add", [x_lm, x_aa], ["embed_sum"], "Embedding"))
    nodes.append(OnnxNode("Relu", ["embed_sum"], ["h0"],
                          "Embedding_activation"))

    # --- GraphConv stack ---
    prev = "h0"
    concat_inputs = []
    for gi, layer in enumerate(params["gc"]):
        nodes.append(OnnxNode("MatMul", ["A", prev], [f"gc{gi}_agg"],
                              f"GCNN_agg_{gi + 1}"))
        prev = dense(f"gc{gi}", layer, f"gc{gi}_agg", relu=True)
        concat_inputs.append(prev)
    nodes.append(OnnxNode("Concat", concat_inputs, ["gc_concat"],
                          "GCNN_concatenate", {"axis": -1}))

    # --- pool + head ---
    init["pool_axes"] = np.asarray([1], np.int64)
    pool_op = "ReduceMean" if getattr(config, "pool", "sum") == "mean" \
        else "ReduceSum"
    nodes.append(OnnxNode(pool_op, ["gc_concat", "pool_axes"], ["pooled"],
                          "Pooling", {"keepdims": 0}))
    prev = "pooled"
    for fi, layer in enumerate(params["fc"]):
        prev = dense(f"fc{fi}", layer, prev, relu=True)
    head_out = dense("head", params["head"], prev, relu=False)
    init["out_shape"] = np.asarray([-1, config.n_labels, 2], np.int64)
    nodes.append(OnnxNode("Reshape", [head_out, "out_shape"],
                          ["head_reshaped"], "head_reshape"))
    nodes.append(OnnxNode("Softmax", ["head_reshaped"], ["labels"],
                          "head_softmax", {"axis": -1}))

    save_onnx(path, nodes, init,
              inputs=[("A", _F32, [1, "L", "L"]), ("S", _F32, [1, "L", 26])],
              outputs=[("labels", _F32, [1, config.n_labels, 2])],
              graph_name="deepfri_gcn")


def export_cnn_to_onnx(params: dict, config: CNNConfig, path: str):
    """Serialise a CNN parameter tree as an ONNX graph (input ``S`` only)."""
    nodes = []
    init: dict[str, np.ndarray] = {}
    # ONNX Conv is NCW: transpose (1, L, 26) → (1, 26, L)
    nodes.append(OnnxNode("Transpose", ["S"], ["s_ncw"], "to_ncw",
                          {"perm": [0, 2, 1]}))
    branch_outs = []
    for ci, conv in enumerate(params["conv"]):
        # ours (k, in, out) → ONNX (out, in, k)
        init[f"conv{ci}_w"] = np.transpose(
            np.asarray(conv["kernel"], np.float32), (2, 1, 0))
        init[f"conv{ci}_b"] = np.asarray(conv["bias"], np.float32)
        nodes.append(OnnxNode(
            "Conv", ["s_ncw", f"conv{ci}_w", f"conv{ci}_b"],
            [f"conv{ci}_out"], f"conv{ci}",
            {"auto_pad": b"SAME_UPPER"}))
        branch_outs.append(f"conv{ci}_out")
    nodes.append(OnnxNode("Concat", branch_outs, ["conv_concat"],
                          "conv_concat", {"axis": 1}))
    nodes.append(OnnxNode("Relu", ["conv_concat"], ["conv_act"], "conv_relu"))
    nodes.append(OnnxNode("GlobalMaxPool", ["conv_act"], ["pool_ncw"],
                          "global_pool"))
    init["sq_axes"] = np.asarray([2], np.int64)
    nodes.append(OnnxNode("Squeeze", ["pool_ncw", "sq_axes"], ["pooled"],
                          "pool_squeeze"))
    def dense(prefix, layer, x, relu):
        init[f"{prefix}_k"] = np.asarray(layer["kernel"], np.float32)
        nodes.append(OnnxNode("MatMul", [x, f"{prefix}_k"],
                              [f"{prefix}_lin"], prefix))
        cur = f"{prefix}_lin"
        if "bias" in layer:
            init[f"{prefix}_b"] = np.asarray(layer["bias"], np.float32)
            nodes.append(OnnxNode("Add", [cur, f"{prefix}_b"],
                                  [f"{prefix}_biased"], f"{prefix}_bias"))
            cur = f"{prefix}_biased"
        if relu:
            nodes.append(OnnxNode("Relu", [cur], [f"{prefix}_out"],
                                  f"{prefix}_relu"))
            cur = f"{prefix}_out"
        return cur

    prev = "pooled"
    for fi, layer in enumerate(params["fc"]):
        prev = dense(f"fc{fi}", layer, prev, relu=True)
    head_out = dense("head", params["head"], prev, relu=False)
    init["out_shape"] = np.asarray([-1, config.n_labels, 2], np.int64)
    nodes.append(OnnxNode("Reshape", [head_out, "out_shape"],
                          ["head_reshaped"], "head_reshape"))
    nodes.append(OnnxNode("Softmax", ["head_reshaped"], ["labels"],
                          "head_softmax", {"axis": -1}))
    save_onnx(path, nodes, init,
              inputs=[("S", _F32, [1, "L", 26])],
              outputs=[("labels", _F32, [1, config.n_labels, 2])],
              graph_name="deepfri_cnn")


# ---------------------------------------------------------------------------
# Import (ONNX → our params) — topological shape matching
# ---------------------------------------------------------------------------

def _topo_matmul_weights(graph: OnnxGraph):
    """(node, weight, bias|None, bias_name|None) for every MatMul/Gemm with
    an initializer weight, in graph order; bias found from Gemm input C or by
    following the output into an Add with a 1-D initializer. Weights are
    oriented to dataflow (in, out) relative to the data operand."""
    consumers = _consumer_map(graph)
    out = []
    for node in graph.nodes:
        if node.op_type not in ("MatMul", "Gemm"):
            continue
        weight = None
        for pos, i in enumerate(node.inputs[:2]):
            if i in graph.initializers and graph.initializers[i].ndim == 2:
                weight = np.asarray(graph.initializers[i], np.float32)
                # Orient Gemm weights to dataflow (in, out): tf2onnx stores
                # Keras Dense kernels transposed behind transB=1 (and a
                # square kernel can't be disambiguated by shape alone).
                # When the weight is input A (y = op(A) @ x), (in, out)
                # relative to the data operand is op(A).T — i.e. transpose
                # exactly when transA is NOT set.
                if node.op_type == "Gemm":
                    if pos == 1:
                        if node.attributes.get("transB", 0):
                            weight = weight.T
                    else:
                        if not node.attributes.get("transA", 0):
                            weight = weight.T
        if weight is None:
            continue
        bias = None
        bias_name = None
        if node.op_type == "Gemm" and len(node.inputs) > 2:
            b = node.inputs[2]
            if b in graph.initializers:
                bias = np.asarray(graph.initializers[b], np.float32)
                bias_name = b
        else:
            for consumer in consumers.get(node.outputs[0], []):
                if consumer.op_type == "Add":
                    for i in consumer.inputs:
                        if (i in graph.initializers
                                and graph.initializers[i].ndim == 1):
                            bias = np.asarray(graph.initializers[i],
                                              np.float32)
                            bias_name = i
        out.append((node, weight, bias, bias_name))
    return out


def _take_matmul(entries, in_dim, out_dim, what):
    """Pop the first entry matching (in, out) [or its transpose]; returns
    (weight, bias|None, bias_name|None)."""
    for idx, (node, w, b, bn) in enumerate(entries):
        if w.shape == (in_dim, out_dim):
            entries.pop(idx)
            return w, b, bn
        if w.shape == (out_dim, in_dim) and in_dim != out_dim:
            entries.pop(idx)
            return w.T, b, bn
    raise ValueError(
        f"Could not locate {what} weight of shape ({in_dim}, {out_dim}) "
        f"in ONNX graph; remaining shapes: "
        f"{[e[1].shape for e in entries]}")


def _assert_biases_consumed(graph: OnnxGraph, consumed: set):
    """Raise if any initializer-backed bias in the dataflow was not mapped
    onto the parameter tree.

    A "bias" is a 1-D float initializer feeding an Add whose other operand is
    computed (or a Gemm C input). Silently zero-filling or discarding such a
    term would import real weights wrong and surface only as a downstream
    parity failure — fail loudly at import instead.
    """
    leftovers = []
    for node in graph.nodes:
        if node.op_type == "Add":
            inits = [i for i in node.inputs
                     if i in graph.initializers
                     and graph.initializers[i].ndim == 1
                     and np.issubdtype(
                         np.asarray(graph.initializers[i]).dtype,
                         np.floating)]
            others = [i for i in node.inputs if i not in graph.initializers]
            if len(inits) == 1 and others and inits[0] not in consumed:
                leftovers.append((node.name, inits[0],
                                  graph.initializers[inits[0]].shape))
        elif node.op_type == "Gemm" and len(node.inputs) > 2:
            c = node.inputs[2]
            if (c in graph.initializers and graph.initializers[c].ndim == 1
                    and c not in consumed):
                leftovers.append((node.name, c, graph.initializers[c].shape))
    if leftovers:
        detail = ", ".join(f"node {n!r} adds initializer {i!r} shape {s}"
                           for n, i, s in leftovers)
        raise ValueError(
            f"ONNX graph carries bias terms the importer did not consume: "
            f"{detail}. Refusing to import with silently dropped "
            f"parameters — the graph structure does not match the supported "
            f"DeepFRI layer layout (inspect with verify-weights --trace).")


def _layer_dict(kernel, bias) -> dict:
    layer = {"kernel": np.ascontiguousarray(kernel)}
    if bias is not None:
        layer["bias"] = np.ascontiguousarray(bias)
    return layer


def import_gcn_params(graph: OnnxGraph, config: GCNConfig) -> dict:
    """Map a DeepFRI GCN ONNX graph onto our parameter tree.

    LSTM layers are matched in graph order; dense weights by expected shape
    in topological order (matching is structural, not name-based). Biases
    are *bias-complete*: every layer's bias found in the graph — including
    GraphConv and LM-embedding biases the published architecture doesn't
    have — is consumed into the parameter tree; a layer without one gets no
    bias term (never a silent zero-fill); and import raises if any
    initializer-backed bias in the dataflow is left unmatched.
    """
    layers = collect_lstm_layers(graph)
    if len(layers) != config.lm_layers:
        raise ValueError(
            f"Expected {config.lm_layers} LSTM layers, found "
            f"{len(layers)}; adjust GCNConfig.lm_layers")
    lm = [lstm_params_from_onnx(W, R, B) for W, R, B in layers]

    entries = _topo_matmul_weights(graph)
    consumed: set = set()

    def take(in_dim, out_dim, what):
        w, b, bn = _take_matmul(entries, in_dim, out_dim, what)
        if bn is not None:
            consumed.add(bn)
        return w, b

    lm_out = config.lm_hidden * (2 if getattr(config, "lm_bidirectional",
                                              False) else 1)
    lm_k, lm_b = take(lm_out, config.embed_dim, "LM embedding")
    aa_k, aa_b = take(config.vocab, config.embed_dim, "AA embedding")
    params = {
        "lm": lm,
        "lm_embed": _layer_dict(lm_k, lm_b),
        "aa_embed": _layer_dict(aa_k, aa_b),
        "gc": [], "fc": [],
    }
    in_dim = config.embed_dim
    for d in config.gc_dims:
        k, b = take(in_dim, d, "GraphConv")
        params["gc"].append(_layer_dict(k, b))
        in_dim = d
    in_dim = sum(config.gc_dims)
    for d in config.fc_dims:
        k, b = take(in_dim, d, "FC")
        params["fc"].append(_layer_dict(k, b))
        in_dim = d
    k, b = take(in_dim, 2 * config.n_labels, "head")
    params["head"] = _layer_dict(k, b)
    if entries:
        raise ValueError(
            f"ONNX graph contains {len(entries)} dense weight(s) the "
            f"inferred GCN architecture does not account for (shapes "
            f"{[e[1].shape for e in entries]}) — refusing a partial import.")
    _assert_biases_consumed(graph, consumed)
    return params


def import_cnn_params(graph: OnnxGraph, config: CNNConfig) -> dict:
    conv_nodes = [n for n in graph.nodes if n.op_type == "Conv"]
    if len(conv_nodes) != len(config.conv_kernels):
        raise ValueError(
            f"Expected {len(config.conv_kernels)} Conv branches, found "
            f"{len(conv_nodes)}")
    params = {"conv": [], "fc": []}
    # Match conv branches by kernel width.
    by_width = {}
    for node in conv_nodes:
        w = np.asarray(graph.initializers[node.inputs[1]], np.float32)
        b = (np.asarray(graph.initializers[node.inputs[2]], np.float32)
             if len(node.inputs) > 2 else np.zeros(w.shape[0], np.float32))
        by_width.setdefault(w.shape[-1], []).append((w, b))
    for ksize in config.conv_kernels:
        if ksize not in by_width or not by_width[ksize]:
            raise ValueError(f"No Conv branch with kernel size {ksize}")
        w, b = by_width[ksize].pop(0)
        params["conv"].append({
            "kernel": np.ascontiguousarray(np.transpose(w, (2, 1, 0))),
            "bias": np.ascontiguousarray(b)})

    entries = _topo_matmul_weights(graph)
    consumed: set = set()

    def take(in_dim, out_dim, what):
        w, b, bn = _take_matmul(entries, in_dim, out_dim, what)
        if bn is not None:
            consumed.add(bn)
        return w, b

    in_dim = config.conv_filters * len(config.conv_kernels)
    for d in config.fc_dims:
        k, b = take(in_dim, d, "FC")
        params["fc"].append(_layer_dict(k, b))
        in_dim = d
    k, b = take(in_dim, 2 * config.n_labels, "head")
    params["head"] = _layer_dict(k, b)
    if entries:
        raise ValueError(
            f"ONNX graph contains {len(entries)} dense weight(s) the "
            f"inferred CNN architecture does not account for (shapes "
            f"{[e[1].shape for e in entries]}) — refusing a partial import.")
    _assert_biases_consumed(graph, consumed)
    return params


# ---------------------------------------------------------------------------
# Structural graph analysis (merge form, pooling mode, stage tensors)
# ---------------------------------------------------------------------------

def _reduce_axes(node: OnnxNode, graph: OnnxGraph):
    axes = node.attributes.get("axes")
    if axes is None and len(node.inputs) > 1 and node.inputs[1]:
        ini = graph.initializers.get(node.inputs[1])
        if ini is not None:
            axes = [int(a) for a in np.asarray(ini).reshape(-1)]
    return list(axes) if axes is not None else None


def detect_embedding_merge(graph: OnnxGraph, vocab: int = 26):
    """Classify how the LM and residue-embedding branches merge.

    Floods forward from (a) every LSTM output and (b) the output of the
    MatMul consuming the (vocab, E) residue-embedding kernel; the first node
    (in graph order) with inputs from both floods is the merge point.
    Returns its op type lower-cased ('add', 'concat', ...) or None when no
    merge exists (e.g. a CNN graph).
    """
    consumers = _consumer_map(graph)

    def flood(seeds):
        reach, stack = set(), list(seeds)
        while stack:
            t = stack.pop()
            if t in reach:
                continue
            reach.add(t)
            for node in consumers.get(t, []):
                stack.extend(o for o in node.outputs if o)
        return reach

    lstm_seeds = [o for n in graph.nodes if n.op_type == "LSTM"
                  for o in n.outputs if o]
    aa_seeds = []
    for node, w, _b, _bn in _topo_matmul_weights(graph):
        if w.shape[0] == vocab:
            aa_seeds.extend(o for o in node.outputs if o)
    if not lstm_seeds or not aa_seeds:
        return None
    lm_reach = flood(lstm_seeds)
    aa_reach = flood(aa_seeds)
    for node in graph.nodes:
        ins = set(node.inputs)
        if ins & lm_reach and ins & aa_reach and not (ins & lm_reach
                                                      & aa_reach):
            return node.op_type.lower()
    return None


def detect_gcn_pool(graph: OnnxGraph) -> str:
    """'sum' or 'mean' — the Reduce over the length axis that pools the
    GraphConv concatenation (identified structurally by its Concat feed)."""
    producers = _producer_map(graph)
    for node in graph.nodes:
        if node.op_type not in ("ReduceSum", "ReduceMean"):
            continue
        if _reduce_axes(node, graph) != [1]:
            continue
        src = producers.get(node.inputs[0])
        if src is not None and src.op_type == "Concat":
            return "mean" if node.op_type == "ReduceMean" else "sum"
    return "sum"


def _walk_fc_stages(graph: OnnxGraph, consumers, start: str):
    """Follow the pooled tensor through the FC stack; yields per-layer
    post-ReLU tensor names, stopping at the (non-ReLU'd) head."""
    names = []
    cur = start
    while True:
        mats = [n for n in consumers.get(cur, [])
                if n.op_type in ("MatMul", "Gemm")]
        if not mats:
            break
        out = mats[0].outputs[0]
        adds = [n for n in consumers.get(out, []) if n.op_type == "Add"]
        if adds:
            out = adds[0].outputs[0]
        relus = [n for n in consumers.get(out, []) if n.op_type == "Relu"]
        if not relus:
            break
        cur = relus[0].outputs[0]
        names.append(cur)
    return names


def gcn_stage_tensors(graph: OnnxGraph) -> list:
    """Ordered [(stage, onnx_tensor_name)] matching the named stages of
    :func:`..deepfri.gcn_forward_stages`.

    Resolution is structural on a :func:`normalize_graph`-ed graph;
    normalisation never renames a kept node's outputs, so the returned names
    also index the raw graph's execution trace.
    """
    producers = _producer_map(graph)
    consumers = _consumer_map(graph)
    pool_node = concat = None
    for node in graph.nodes:
        if node.op_type in ("ReduceSum", "ReduceMean") \
                and _reduce_axes(node, graph) == [1]:
            src = producers.get(node.inputs[0])
            if src is not None and src.op_type == "Concat":
                pool_node, concat = node, src
                break
    if pool_node is None:
        raise ValueError("No GraphConv pooling Reduce found in graph")
    stages = []
    # embed = the feature operand of the first layer's aggregation MatMul
    lin = producers[concat.inputs[0]]              # Relu
    lin = producers[lin.inputs[0]]                 # MatMul or bias Add
    if lin.op_type == "Add":
        data = [i for i in lin.inputs if i not in graph.initializers]
        lin = producers[data[0]]
    agg = producers[lin.inputs[0]]                 # MatMul(A_used, h)
    stages.append(("embed", agg.inputs[1]))
    for gi, t in enumerate(concat.inputs):
        stages.append((f"gc{gi}", t))
    stages.append(("pooled", pool_node.outputs[0]))
    for fi, t in enumerate(_walk_fc_stages(graph, consumers,
                                           pool_node.outputs[0])):
        stages.append((f"fc{fi}", t))
    softmax = next(n for n in graph.nodes if n.op_type == "Softmax")
    stages.append(("logits", softmax.inputs[0]))
    stages.append(("scores", softmax.outputs[0]))
    return stages


def cnn_stage_tensors(graph: OnnxGraph) -> list:
    """Ordered [(stage, onnx_tensor_name)] matching
    :func:`..deepfri.cnn_forward_stages` (pooled → fc* → logits → scores)."""
    producers = _producer_map(graph)
    consumers = _consumer_map(graph)
    pooled = None
    for node in graph.nodes:
        if node.op_type == "ReduceMax" and _reduce_axes(node, graph) == [1]:
            pooled = node.outputs[0]
            break
        if node.op_type == "GlobalMaxPool":
            pooled = node.outputs[0]
            sq = [n for n in consumers.get(pooled, [])
                  if n.op_type in ("Squeeze", "Reshape", "Flatten")]
            if sq:
                pooled = sq[0].outputs[0]
            break
    if pooled is None:
        raise ValueError("No global max-pool found in CNN graph")
    stages = [("pooled", pooled)]
    for fi, t in enumerate(_walk_fc_stages(graph, consumers, pooled)):
        stages.append((f"fc{fi}", t))
    softmax = next(n for n in graph.nodes if n.op_type == "Softmax")
    stages.append(("logits", softmax.inputs[0]))
    stages.append(("scores", softmax.outputs[0]))
    return stages


def infer_n_labels(graph: OnnxGraph) -> int:
    """Read n_labels from the graph output shape (1, n_labels, 2)."""
    for vi in graph.outputs:
        dims = [d for d in vi.shape if isinstance(d, int)]
        if len(vi.shape) == 3 and isinstance(vi.shape[1], int):
            return vi.shape[1]
    raise ValueError("Could not infer n_labels from ONNX graph outputs")
