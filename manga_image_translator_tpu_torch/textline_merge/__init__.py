"""Textline → text-region merging (pure host geometry).

Contract from reference ``textline_merge/__init__.py:10-208``: build a graph
with edges where :func:`can_merge_textline` holds, take connected components,
recursively split each component by Kruskal-MST edge-weight outliers, then
majority-vote direction, average colors, and sort lines in reading order.

Host work: the graph is O(lines²), a few hundred pairs on a dialogue page.
Decided one pair at a time it took most of this stage, with the card idle
throughout, so ``merge_graph_edges`` decides all pairs at once.
"""
from __future__ import annotations

import itertools
from collections import Counter
from typing import List, Set

import networkx as nx
import numpy as np

from ..utils.geometry import Quadrilateral, merge_graph_edges
from ..utils.profiling import span
from ..utils.textblock import TextBlock

# ``can_merge_textline``'s tolerances for lines of one region
MERGE_TOLERANCES = dict(aspect_ratio_tol=1.3, font_size_ratio_tol=2,
                        char_gap_tolerance=1, char_gap_tolerance2=3)


def split_text_region(bboxes: List[Quadrilateral],
                      connected_region_indices: Set[int], width: int,
                      height: int, gamma: float = 0.5, sigma: float = 2
                      ) -> List[Set[int]]:
    indices = list(connected_region_indices)

    if len(indices) == 1:
        return [set(indices)]

    if len(indices) == 2:
        a, b = bboxes[indices[0]], bboxes[indices[1]]
        fs = max(a.font_size, b.font_size)
        if (a.distance(b) < (1 + gamma) * fs
                and abs(a.angle - b.angle) < 0.2 * np.pi):
            return [set(indices)]
        return [{indices[0]}, {indices[1]}]

    G = nx.Graph()
    G.add_nodes_from(indices)
    for u, v in itertools.combinations(indices, 2):
        G.add_edge(u, v, weight=bboxes[u].distance(bboxes[v]))
    edges = nx.algorithms.tree.minimum_spanning_edges(
        G, algorithm='kruskal', data=True)
    edges = sorted(edges, key=lambda e: e[2]['weight'], reverse=True)
    distances = [e[2]['weight'] for e in edges]
    fontsize = np.mean([bboxes[i].font_size for i in indices])
    distances_std = np.std(distances)
    distances_mean = np.mean(distances)
    std_threshold = max(0.3 * fontsize + 5, 5)

    b1, b2 = bboxes[edges[0][0]], bboxes[edges[0][1]]
    max_poly_distance = b1.poly_distance(b2)
    max_centroid_alignment = min(abs(b1.centroid[0] - b2.centroid[0]),
                                 abs(b1.centroid[1] - b2.centroid[1]))

    if ((distances[0] <= distances_mean + distances_std * sigma
         or distances[0] <= fontsize * (1 + gamma))
            and (distances_std < std_threshold
                 or (max_poly_distance == 0 and max_centroid_alignment < 5))):
        return [set(indices)]

    # drop the most deviating MST edge and recurse on the pieces
    G = nx.Graph()
    G.add_nodes_from(indices)
    for edge in edges[1:]:
        G.add_edge(edge[0], edge[1])
    out: List[Set[int]] = []
    for node_set in nx.algorithms.components.connected_components(G):
        out.extend(split_text_region(bboxes, node_set, width, height))
    return out


def merge_bboxes_text_region(bboxes: List[Quadrilateral], width: int,
                             height: int):
    G = nx.Graph()
    G.add_nodes_from(range(len(bboxes)))
    G.add_edges_from(merge_graph_edges(bboxes, **MERGE_TOLERANCES))

    region_indices: List[Set[int]] = []
    for node_set in nx.algorithms.components.connected_components(G):
        region_indices.extend(
            split_text_region(bboxes, node_set, width, height))

    for node_set in region_indices:
        nodes = list(node_set)
        txtlns = [bboxes[i] for i in nodes]

        fg_color = tuple(round(float(np.mean([getattr(b, f'fg_{c}')
                                              for b in txtlns])))
                         for c in 'rgb')
        bg_color = tuple(round(float(np.mean([getattr(b, f'bg_{c}')
                                              for b in txtlns])))
                         for c in 'rgb')

        # majority vote for direction; tie broken by most extreme aspect ratio
        dirs = [b.direction for b in txtlns]
        top2 = Counter(dirs).most_common(2)
        if len(top2) == 1:
            majority_dir = top2[0][0]
        elif top2[0][1] == top2[1][1]:
            max_aspect_ratio = -100.0
            majority_dir = top2[0][0]
            for b in txtlns:
                if b.aspect_ratio > max_aspect_ratio:
                    max_aspect_ratio = b.aspect_ratio
                    majority_dir = b.direction
                if 1.0 / b.aspect_ratio > max_aspect_ratio:
                    max_aspect_ratio = 1.0 / b.aspect_ratio
                    majority_dir = b.direction
        else:
            majority_dir = top2[0][0]

        if majority_dir == 'h':
            nodes = sorted(nodes, key=lambda i: bboxes[i].centroid[1])
        elif majority_dir == 'v':
            nodes = sorted(nodes, key=lambda i: -bboxes[i].centroid[0])
        txtlns = [bboxes[i] for i in nodes]
        yield txtlns, fg_color, bg_color


async def dispatch(textlines: List[Quadrilateral], width: int, height: int,
                   verbose: bool = False) -> List[TextBlock]:
    with span('merge.graph'):
        text_regions: List[TextBlock] = []
        for txtlns, fg_color, bg_color in merge_bboxes_text_region(
                textlines, width, height):
            total_logprobs = 0.0
            for q in txtlns:
                total_logprobs += np.log(max(q.prob, 1e-9)) * q.area
            total_logprobs /= max(sum(q.area for q in textlines), 1e-9)

            font_size = int(min(q.font_size for q in txtlns))
            angle = float(np.rad2deg(np.mean([q.angle for q in txtlns])) - 90)
            if abs(angle) < 3:
                angle = 0
            lines = [q.pts for q in txtlns]
            texts = [q.text for q in txtlns]
            region = TextBlock(lines, texts, font_size=font_size, angle=angle,
                               prob=float(np.exp(total_logprobs)),
                               fg_color=fg_color, bg_color=bg_color)
            text_regions.append(region)
        return text_regions
