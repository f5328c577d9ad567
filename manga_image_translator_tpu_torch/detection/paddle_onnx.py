"""ONNX → torch weight mapping for the PaddleOCR DB detector.

A copy of the JAX package's ``detection/paddle_onnx.py`` (the reference
runs a PaddleOCR detection ONNX model through the
``rusty-manga-image-translator`` ORT wheel, detection/common_rust.py:14-63)
on the port's own ``utils/onnx_lite.py``. It yields the state dict of the
port's ``models.paddle_det.PaddleDet``, which ``load_state_dict_into``
loads strictly.

Mapping strategy (robust to node naming, validated by shape), as in the
JAX package:

* enumerate ONNX Conv/ConvTranspose nodes in topological (export) order;
* walk the slots in forward order, consuming ONNX convs by exact
  weight-shape match within a small look-ahead window;
* groups of identically-shaped parallel convs (the FPN's p2..p5 smoothing
  convs) are disambiguated by graph connectivity: BFS up the producer
  chain to the nearest already-assigned lateral conv;
* BatchNormalization nodes are attached to the conv producing their input;
  if the export folded BN into the convs, the BN slots become identity;
* every assignment is shape-checked; any mismatch raises (no silent
  random-weight serving).

The weights keep the ONNX layout, which is torch's (Conv OIHW,
ConvTranspose IOHW). Where the port's conv has no bias (it is followed by a
BN) and the export gives one, the bias moves into the BN's running mean:
BN(conv + b) with mean μ equals BN(conv) with mean μ - b.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..models.paddle_det import _MNV3_CFG
from ..utils.onnx_lite import OnnxGraph


class PaddleOnnxMappingError(RuntimeError):
    pass


def _slot_manifest() -> List[dict]:
    """Our conv slots in forward order: name, OIHW shape, has-bn, kind,
    optional connectivity hint (name of parent slot for ambiguous groups)."""
    slots: List[dict] = []

    def conv_bn(key, k, ci, co, groups=1):
        slots.append(dict(key=key, oihw=(co, ci // groups, k, k), bn=True,
                          kind='conv'))

    conv_bn('backbone.conv0', 3, 3, 8)
    cin = 8
    for i, (k, e, o, se, act, s) in enumerate(_MNV3_CFG):
        pre = f'backbone.block{i}'
        conv_bn(f'{pre}.expand', 1, cin, e)
        conv_bn(f'{pre}.depthwise', k, e, e, groups=e)
        if se:
            slots.append(dict(key=f'{pre}.se.conv1', oihw=(e // 4, e, 1, 1),
                              bn=False, kind='conv'))
            slots.append(dict(key=f'{pre}.se.conv2', oihw=(e, e // 4, 1, 1),
                              bn=False, kind='conv'))
        conv_bn(f'{pre}.linear', 1, e, o)
        cin = o
    conv_bn('backbone.conv_last', 1, cin, 480)

    chans = {'in2': 12, 'in3': 20, 'in4': 56, 'in5': 480}
    for name in ('in5', 'in4', 'in3', 'in2'):     # our forward order
        slots.append(dict(key=f'neck.{name}', oihw=(96, chans[name], 1, 1),
                          bn=False, kind='conv'))
    for name in ('p5', 'p4', 'p3', 'p2'):
        slots.append(dict(key=f'neck.{name}', oihw=(24, 96, 3, 3),
                          bn=False, kind='conv', hint=f'neck.in{name[1]}'))
    for head in ('binarize', 'thresh'):
        slots.append(dict(key=f'head.{head}.conv1', oihw=(24, 96, 3, 3),
                          bn=True, kind='conv', head=head))
        slots.append(dict(key=f'head.{head}.conv2', oihw=(24, 24, 2, 2),
                          bn=True, kind='conv_t', head=head))
        slots.append(dict(key=f'head.{head}.conv3', oihw=(1, 24, 2, 2),
                          bn=False, kind='conv_t', head=head))
    return slots


def _identity_bn(params: Dict, key: str, c: int):
    params[f'{key}.weight'] = np.ones((c,), np.float32)
    params[f'{key}.bias'] = np.zeros((c,), np.float32)
    params[f'{key}.running_mean'] = np.zeros((c,), np.float32)
    params[f'{key}.running_var'] = np.ones((c,), np.float32)


def _has_bias(slot: dict) -> bool:
    """Whether the port's module for ``slot`` has a conv bias: those
    followed by a BN do not (the transposed head conv does)."""
    return not slot['bn'] or slot['kind'] == 'conv_t'


def _keys(slot: dict):
    """(conv key, BN key or None) of a slot in the port's state dict."""
    key = slot['key']
    if not slot['bn']:
        return key, None
    if key.startswith('head.'):
        return key, key.replace('conv1', 'bn1').replace('conv2', 'bn2')
    return f'{key}.conv', f'{key}.bn'


def convert_graph(graph: OnnxGraph) -> Dict[str, np.ndarray]:
    inits = graph.initializers
    producer = {}
    for idx, node in enumerate(graph.nodes):
        for out in node.outputs:
            producer[out] = idx

    convs: List[dict] = []       # topo-order conv nodes with weights
    bn_for_input: Dict[str, int] = {}
    for idx, node in enumerate(graph.nodes):
        if node.op_type in ('Conv', 'ConvTranspose') and len(node.inputs) > 1:
            wname = node.inputs[1]
            if wname not in inits:
                raise PaddleOnnxMappingError(
                    f'conv {node.name}: weight {wname} not an initializer')
            convs.append(dict(
                idx=idx, node=node, w=inits[wname],
                b=inits.get(node.inputs[2]) if len(node.inputs) > 2 else None,
                transposed=node.op_type == 'ConvTranspose', assigned=False))
        elif node.op_type == 'BatchNormalization':
            bn_for_input[node.inputs[0]] = idx

    def conv_shape(c):
        return tuple(int(d) for d in c['w'].shape)

    def exp_shape(slot, c):
        o, i, kh, kw = slot['oihw']
        if c['transposed']:
            return (i, o, kh, kw)     # ONNX ConvTranspose stores (I, O, H, W)
        return slot['oihw']

    assigned: Dict[str, dict] = {}   # slot key -> conv record

    def bfs_nearest_assigned(conv_idx: int, candidates: set) -> Optional[str]:
        """BFS up the producer graph from a conv node's data input to the
        nearest conv assigned to one of ``candidates`` (slot keys)."""
        start = graph.nodes[conv_idx].inputs[0]
        seen = set()
        q = deque([start])
        while q:
            tensor = q.popleft()
            if tensor in seen or tensor not in producer:
                continue
            seen.add(tensor)
            nidx = producer[tensor]
            for key in candidates:
                if assigned.get(key, {}).get('idx') == nidx:
                    return key
            q.extend(graph.nodes[nidx].inputs[:1]
                     if graph.nodes[nidx].op_type in ('Conv', 'ConvTranspose')
                     else graph.nodes[nidx].inputs)
        return None

    slots = _slot_manifest()
    params: Dict[str, np.ndarray] = {}
    cursor = 0
    WINDOW = 12
    lateral_keys = {'neck.in2', 'neck.in3', 'neck.in4', 'neck.in5'}

    # Single pass in forward (manifest) order: hinted slots (the four
    # identically-shaped FPN p-convs) resolve by graph connectivity; plain
    # slots consume the next shape-matching conv within a look-ahead window.
    # Ordering matters: the p-convs claim their shape-mates before the head
    # conv1 slots (same 24x96x3x3 shape) get a chance to steal them.
    for slot in slots:
        found = None
        if 'hint' in slot:
            for c in convs:
                if c['assigned'] or conv_shape(c) != exp_shape(slot, c):
                    continue
                if bfs_nearest_assigned(c['idx'],
                                        lateral_keys) == slot['hint']:
                    found = c
                    break
            if found is None:          # fall back to export order
                found = next((c for c in convs if not c['assigned']
                              and conv_shape(c) == exp_shape(slot, c)),
                             None)
        else:
            for j in range(cursor, min(cursor + WINDOW, len(convs))):
                c = convs[j]
                if (not c['assigned']
                        and conv_shape(c) == exp_shape(slot, c)
                        and c['transposed'] == (slot['kind'] == 'conv_t')):
                    found = c
                    break
        if found is None:
            if slot['key'].startswith('head.thresh'):
                # inference exports often ship only the binarize branch;
                # postprocess never reads the thresh map, zero it.
                o, i, kh, kw = slot['oihw']
                conv_key, bn_key = _keys(slot)
                shape = ((i, o, kh, kw) if slot['kind'] == 'conv_t'
                         else (o, i, kh, kw))
                params[f'{conv_key}.weight'] = np.zeros(shape, np.float32)
                if _has_bias(slot):
                    params[f'{conv_key}.bias'] = np.zeros((o,), np.float32)
                if bn_key is not None:
                    _identity_bn(params, bn_key, o)
                continue
            raise PaddleOnnxMappingError(
                f"no ONNX conv matches slot {slot['key']} "
                f"(OIHW {slot['oihw']}) near position {cursor}")
        found['assigned'] = True
        assigned[slot['key']] = found
        _emit(params, slot, found, graph, bn_for_input, inits)
        while cursor < len(convs) and convs[cursor]['assigned']:
            cursor += 1

    return params


def _emit(params: Dict, slot: dict, c: dict, graph: OnnxGraph,
          bn_for_input: Dict[str, int], inits: Dict):
    """Write one conv slot (+ its BN if any) into the state dict."""
    conv_key, bn_key = _keys(slot)
    params[f'{conv_key}.weight'] = np.ascontiguousarray(
        np.asarray(c['w'], np.float32))
    o = slot['oihw'][0]
    bias = (np.asarray(c['b'], np.float32) if c['b'] is not None
            else np.zeros((o,), np.float32))
    if _has_bias(slot):
        params[f'{conv_key}.bias'] = bias
    if bn_key is None:
        return
    bn_idx = bn_for_input.get(c['node'].outputs[0])
    if bn_idx is None:
        _identity_bn(params, bn_key, o)           # folded export
    else:
        bn = graph.nodes[bn_idx]
        scale, beta, mean, var = (np.asarray(inits[n], np.float32)
                                  for n in bn.inputs[1:5])
        params[f'{bn_key}.weight'] = scale
        params[f'{bn_key}.bias'] = beta
        params[f'{bn_key}.running_mean'] = mean
        params[f'{bn_key}.running_var'] = var
    if not _has_bias(slot):
        params[f'{bn_key}.running_mean'] = (
            params[f'{bn_key}.running_mean'] - bias)
